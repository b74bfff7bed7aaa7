"""Device ms a step of the kernels that the sweeps layer's pattern files
(``layers/sweeps.*.json``) name, in the profiled solve."""

import core


def read(record: dict) -> float | None:
    s = core.layer_seconds(record, "sweeps")
    return s * 1e3 / record["profile"]["steps"] if s else None
