"""Lane-rows the band kernels test per pair within h, in the profiled
solve: the port's counter ``sweeps.rows_tested`` (per warp, 32 lanes times
the rows of the union of its lanes' bands, over the 9 rods, for each K1
and K2 launch) over launches times N times the solve's mean neighbor
count.  The rows tested include each row itself; the pairs do not."""

import spans


def read(record: dict) -> float | None:
    got = spans.taken(record)
    c = (got or {}).get("counts", {}).get("sweeps.rows_tested")
    nbr = record["profile"]["neighbor_mean"] if got else 0
    if not c or not c["times"] or not nbr:
        return None
    return c["total"] / (c["times"] * record["particles"] * nbr)
