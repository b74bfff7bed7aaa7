"""Host ms a step in the port's span ``driver.drift_read``: the drift test
and its host read, the step's one sync, in the profiled solve."""

import spans


def read(record: dict) -> float | None:
    ms = spans.host_ms(record, "driver.drift_read")
    return None if ms is None else ms / record["profile"]["steps"]
