"""The comparison that decides ``correct``: a step's outputs, in the
original particle order, against the reference's from the same state.

Each number is one plain float (an exact number is a count) and is held to
the limit of the same name in ``limits/<config>.json``.  A non-finite
output reads as infinite, so it fails every limit.
"""

from __future__ import annotations

import math

import torch

# the numbers ``step_numbers`` returns, in the order they are printed
STEP_NUMBERS = ("count_rows_differ", "rho_rel_err", "acc_err", "pos_err",
                "vel_err")


def _finite_or_inf(x: torch.Tensor) -> float:
    v = float(x)
    return v if math.isfinite(v) else math.inf


def _rows_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x.double(), dim=-1)


def step_numbers(out: dict, ref: dict, h: float) -> dict:
    """``out`` and ``ref`` hold the step's ``count`` [N], ``rho`` [N],
    ``acc`` [N, 3], ``pos`` [N, 3] and ``vel`` [N, 3] in one particle order.

    - count_rows_differ: particles whose neighbor count differs (exact);
    - rho_rel_err: the largest |rho - rho_ref| / rho_ref;
    - acc_err, vel_err: the largest |a - a_ref| over the root mean square
      of |a_ref| (vectors per particle; the same for velocities);
    - pos_err: the largest |x - x_ref| over h.
    """
    rho_r = ref["rho"].double()
    nums = {
        "count_rows_differ": float((out["count"].long()
                                    != ref["count"].long()).sum()),
        "rho_rel_err": _finite_or_inf(
            ((out["rho"].double() - rho_r).abs() / rho_r.abs()).max()),
        "pos_err": _finite_or_inf(
            _rows_norm(out["pos"].double() - ref["pos"].double()).max() / h),
    }
    for k in ("acc", "vel"):
        rms = _rows_norm(ref[k]).square().mean().sqrt().clamp(min=1e-30)
        nums[f"{k}_err"] = _finite_or_inf(
            _rows_norm(out[k].double() - ref[k].double()).max() / rms)
    if not all(torch.isfinite(out[k]).all() for k in ("rho", "acc", "pos",
                                                      "vel")):
        nums = {k: math.inf for k in nums}
    return {k: nums[k] for k in STEP_NUMBERS}


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over several steps."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}).  A
    number with no limit fails."""
    table = {k: {"value": v, "limit": limits.get(k)}
             for k, v in numbers.items()}
    ok = all(t["limit"] is not None and t["value"] <= t["limit"]
             for t in table.values())
    return ok, table
