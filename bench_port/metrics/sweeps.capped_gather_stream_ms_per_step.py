"""Stream ms a step summed over the port's ``sweeps.capped_gather`` spans
(the sub frame's rows gathered and its candidate columns built), event to
event on the card's stream, in the profiled solve; None where the port
opens no such span."""

import spans


def read(record: dict) -> float | None:
    ms = spans.stream_ms(record, "sweeps.capped_gather")
    return None if ms is None else sum(ms) / record["profile"]["steps"]
