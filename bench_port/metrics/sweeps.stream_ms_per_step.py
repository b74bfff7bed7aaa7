"""Stream ms a step in the port's span ``sweeps.sorted`` (K1, the candidate
columns, K2, gravity and the CFL clamp), event to event on the card's
stream, in the profiled solve; its excess over
``sweeps.device_ms_per_step`` is the sweeps module's own glue."""

import spans


def read(record: dict) -> float | None:
    ms = spans.stream_ms(record, "sweeps.sorted")
    return None if ms is None else sum(ms) / record["profile"]["steps"]
