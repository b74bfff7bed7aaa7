"""The capped sweeps' work in a step, counted from the equations and the
state's size, as ``work.py`` counts the exact sweeps', with its peaks.

Pairs: N times the step's mean neighbor count, which in capped mode counts
the kept candidates within h that the walks sum (each particle's own row
excluded).  A pair costs ``work.PAIR_FLOPS``, 41 operations: the
candidate's reweighted mass (occupancy / kept times its mass) is made once
at each binning, so it adds no operation a pair, and the force reads it as
it reads an exact candidate's mass.

Bytes: each particle's ``work.PARTICLE_BYTES``, 48, and each kept row's
candidate fields, read once a step: position 12, velocity 12, reweighted
mass 4 and density 4, 32 a kept row.  The kept rows a step are the port's
counter ``capped.kept_rows`` over the steps it was counted in.
"""

from __future__ import annotations

import work

KEPT_ROW_BYTES = 12 + 12 + 4 + 4


def sweeps_bound(n: int, neighbor_mean: float, kept_rows: float) -> dict:
    """The least time one capped step's sweeps could take on the card: the
    larger of its operations over the float32 peak and its bytes over the
    HBM bandwidth, and which of the two it is."""
    flops = n * neighbor_mean * work.PAIR_FLOPS
    nbytes = n * work.PARTICLE_BYTES + kept_rows * KEPT_ROW_BYTES
    t_flops = flops / work.PEAK_F32_FLOPS
    t_bytes = nbytes / work.PEAK_HBM_BYTES
    return {"flops": flops, "bytes": nbytes, "flops_s": t_flops,
            "bytes_s": t_bytes, "bound_s": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes"}


def kept_rows_per_step(counts: dict) -> float | None:
    """The counter ``capped.kept_rows``'s mean over the steps that counted
    it (``utils/trace.take()``'s ``counts``); None where none did."""
    c = counts.get("capped.kept_rows")
    if not c or not c["times"]:
        return None
    return c["total"] / c["times"]
