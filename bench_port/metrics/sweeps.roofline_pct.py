"""The step's pair work bound (``work.sweeps_bound``: the larger of its
operations over the float32 peak and its bytes over the HBM bandwidth) as
a share of the sweeps layer's device time a step."""

import core


def read(record: dict) -> float | None:
    s = core.layer_seconds(record, "sweeps")
    if not s:
        return None
    return 100.0 * record["bound"]["bound_s"] * record["profile"]["steps"] / s
