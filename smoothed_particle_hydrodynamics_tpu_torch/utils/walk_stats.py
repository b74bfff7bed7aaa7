"""Rows a sweep kernel tests per thread, read from its window tables: the
quantity the sweep kernels' time follows (most tested rows are rejected).

    python -m smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats

prints it on the CPU for a thin analog of the 1M splash: a 128x128x16 grid
keeps the 1M scene's 128-cell x-rows and its pool height at ~124k
particles, for the lane layout (1.0h cells, window 512) and for the sublane
headline shapes (1.25h cells, window 208): the block walk's rows and the
exact band kernels' (``band_rows_per_lane``), with the mean neighbor count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WARP = 32


def lane_rows_per_thread(cfg, p) -> float:
    """Mean over blocks of sum over rods of chunks * window (the lane
    kernels walk whole chunks)."""
    return float(p.wc.double().sum() * cfg.pallas_window
                 / (p.wc.numel() // 9))


def sublane_rows_per_thread(cfg, p, m: int) -> float:
    """Mean over blocks of sum over rods of min(ws + wc*s_t, m) - ws (the
    sublane kernels stop at the candidate count)."""
    stop = torch.clamp(p.ws.long() + p.wc.long() * cfg.pallas_window_t,
                       max=m)
    return float((stop - p.ws.long()).clamp(min=0).double().sum()
                 / (p.wc.numel() // 9))


def band_rows_per_lane(cfg, p) -> dict:
    """Rows the exact band kernels test per self row (``sweeps_t.
    band_ranges`` of the cell-start table), summed over the 9 rods:
    ``mean`` over the rows; ``warp_max``, the mean over warps (32
    consecutive rows) of the sum over rods of their longest lane band (the
    rows a warp steps through); ``warp_union``, the same mean of the rows of
    the union [min a, max e) of the warp's non-empty bands, per rod."""
    from ..ops.sweeps_t import band_ranges

    a, e = band_ranges(cfg, p.cid, p.cell_start)
    n = a.shape[0]
    pad = (0, 0, 0, -(-n // WARP) * WARP - n)

    def per_warp(x, value=0):
        return F.pad(x, pad, value=value).view(-1, WARP, x.shape[1])

    big = n + 1   # above every row: a, e <= n
    some = e > a
    lo = per_warp(torch.where(some, a, big), big).amin(1)
    hi = per_warp(torch.where(some, e, 0)).amax(1)
    longest = per_warp((e - a).clamp(min=0)).amax(1)
    return {"mean": (e - a).clamp(min=0).sum(1).double().mean().item(),
            "warp_max": longest.sum(1).double().mean().item(),
            "warp_union": (hi - lo).clamp(min=0).sum(1).double().mean().item()}


def main() -> None:
    from ..models import make_scene
    from ..ops import sweeps_lane, sweeps_t

    thin = dict(device="cpu", grid_nx=128, grid_ny=128, grid_nz=16)
    # pool heights of the 1M scenes: 13.6 lattice layers on 1.0h cells,
    # 8.68 on 1.25h cells (the pool's footprint is the box floor)
    cfg, st = make_scene("splash", num_particles=124_000,
                         pallas_layout="lane", **thin)
    p = sweeps_lane.prepare_lane(cfg, st)
    _, nc = sweeps_lane.density_lane(cfg, sweeps_lane.density_fields(cfg, p),
                                     p.ws, p.wc, st.n)
    print(f"lane    (1.0h cells, window {cfg.pallas_window}): "
          f"{lane_rows_per_thread(cfg, p):.1f} rows/thread, "
          f"mean neighbors {nc.double().mean().item():.2f}")
    cfg, st = make_scene("splash", num_particles=124_603, cell_size_factor=1.25,
                         pallas_window_t=208, **thin)
    p = sweeps_t.prepare_t(cfg, st)
    _, nc = sweeps_t.density_sweep_t(cfg, p)
    print(f"sublane (1.25h cells, window {cfg.pallas_window_t}): "
          f"{sublane_rows_per_thread(cfg, p, st.n):.1f} rows/thread, "
          f"mean neighbors {nc.double().mean().item():.2f}")
    band = band_rows_per_lane(cfg, p)
    print(f"band    (1.25h cells, exact): {band['mean']:.1f} rows/lane, "
          f"max over a warp {band['warp_max']:.1f}, warp union "
          f"{band['warp_union']:.1f}")


if __name__ == "__main__":
    main()
