"""Stream ms a step in the port's span ``integrate.kdk`` (the KDK update,
the boundary and the energy tally), event to event on the card's stream,
in the profiled solve."""

import spans


def read(record: dict) -> float | None:
    ms = spans.stream_ms(record, "integrate.kdk")
    return None if ms is None else sum(ms) / record["profile"]["steps"]
