"""The capped step's sweep work bound (``work_capped.sweeps_bound``: the
larger of its operations over the float32 peak and its bytes over the HBM
bandwidth, with the kept rows of the port's counter ``capped.kept_rows``)
as a share of the sweeps layer's device time a step; None where the port
counts no kept rows or the sweeps layer shows no device time."""

import core
import spans
import work_capped


def read(record: dict) -> float | None:
    got = spans.taken(record)
    kept = work_capped.kept_rows_per_step(got["counts"]) if got else None
    s = core.layer_seconds(record, "sweeps")
    if kept is None or not s:
        return None
    bound = work_capped.sweeps_bound(record["particles"],
                                     record["profile"]["neighbor_mean"], kept)
    return 100.0 * bound["bound_s"] * record["profile"]["steps"] / s
