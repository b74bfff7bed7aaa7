"""Rows a sweep kernel tests per thread, read from its bands (and the lane
layout's window tables): the quantity the sweep kernels' time follows (most
tested rows are rejected).

    python -m smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats

prints it on the CPU for a thin analog of the 1M splash: a 128x128x16 grid
keeps the 1M scene's 128-cell x-rows and its pool height at ~124k
particles, for the lane layout (1.0h cells, window 512), for the sublane
headline shapes (1.25h cells, window 208) and for capped mode on them
(``capped_candidates`` 4; block, window and sub frame derived as the CLI
derives them) and its fused pre-pass: the lane block walk's rows and the
band kernels' (``band_rows_per_lane``; the lane band kernels'
``lane_band_rows_per_lane``; the slab engine's exact and capped band
kernels' ``slab_band_rows_per_lane`` and ``slab_sub_band_rows_per_lane``;
the fused path's sub-frame pre-pass, ``prepass_rows``), with the mean
neighbor count.
``corner_state`` builds the 4-slab frame on which a slab table over the raw
extended frame would test dead rows.  ``band_sums`` is ``band_stats`` left
on the device, with no host read; 32 times its ``warp_union`` is the
twin of the counter kernel ``sweeps_t.band_rows_t`` (``sweeps.rows_tested``
of ``utils/trace.py``).  ``drain_sums`` is the twin of K2's own counters,
its pairs and drain rounds (``sweeps.force_pairs``,
``sweeps.force_rounds``).
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


def _per_warp(x: torch.Tensor, value=0) -> torch.Tensor:
    """[n, r] -> [warps, WARP, r], the last warp padded with ``value``."""
    pad = (0, 0, 0, -x.shape[0] % WARP)
    return F.pad(x, pad, value=value).view(-1, WARP, x.shape[1])


def _union_lo(a: torch.Tensor, e: torch.Tensor, big: int) -> torch.Tensor:
    """[warps, r]: the first row of each warp's union of its non-empty
    bands in each rod (``big`` where all are empty)."""
    return _per_warp(torch.where(e > a, a, big), big).amin(1)


def band_sums(a: torch.Tensor, e: torch.Tensor, m: int) -> dict:
    """``band_stats``' sums, left on the bands' device (no host read): 0-d
    int64 tensors ``rows`` (over the rows), ``warp_max`` and ``warp_union``
    (over the warps), beside the counts ``n`` of rows and ``warps``."""
    n = a.shape[0]
    lo = _union_lo(a, e, m + 1)   # above every candidate row: a, e <= m
    hi = _per_warp(torch.where(e > a, e, 0)).amax(1)
    longest = _per_warp((e - a).clamp(min=0)).amax(1)
    return {"rows": (e - a).clamp(min=0).sum(), "warp_max": longest.sum(),
            "warp_union": (hi - lo).clamp(min=0).sum(), "n": n,
            "warps": -(-n // WARP)}


def drain_sums(a: torch.Tensor, e: torch.Tensor, i: torch.Tensor,
               j: torch.Tensor, piece: int) -> dict:
    """The twin of K2's counters (``force_band_t``'s ``stats``), from its
    bands [a, e) ([n, 9]) and its pairs, self row ``i[k]`` with candidate
    row ``j[k]`` (a row of one of row i's bands): 0-d int64 tensors
    ``pairs``, how many, and ``rounds``, the drain rounds its warps issue:
    summed over the warps (32 consecutive self rows), the rods and the
    pieces of ``piece`` rows that the walk cuts each rod's warp union [min
    a, max e) into, the most pairs any one lane has in the piece."""
    dev = a.device
    if not i.numel():
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return {"pairs": zero, "rounds": zero.clone()}
    i, j = i.long(), j.long()
    lo = _union_lo(a, e, int(e.max()) + 1)
    rod = ((j[:, None] >= a[i]) & (j[:, None] < e[i])).int().argmax(1)
    warp = i // WARP
    q = (j - lo[warp, rod]) // piece
    hits = torch.zeros(lo.shape[0], a.shape[1], int(q.max()) + 1, WARP,
                       dtype=torch.int64, device=dev)
    hits.index_put_((warp, rod, q, i % WARP), torch.ones_like(i),
                    accumulate=True)
    return {"pairs": torch.tensor(i.numel(), device=dev),
            "rounds": hits.amax(-1).sum()}


def band_stats(a: torch.Tensor, e: torch.Tensor, m: int) -> dict:
    """Rows a band kernel tests per self row, from its bands [a, e) ([n, 9],
    empty where e <= a, all rows below ``m``), summed over the 9 rods:
    ``mean`` over the rows; ``warp_max``, the mean over warps (32
    consecutive rows) of the sum over rods of their longest lane band (the
    rows a warp steps through); ``warp_union``, the same mean of the rows of
    the union [min a, max e) of the warp's non-empty bands, per rod."""
    s = band_sums(a, e, m)

    def mean(total, k):
        return total.item() / k if k else float("nan")

    return {"mean": mean(s["rows"], s["n"]),
            "warp_max": mean(s["warp_max"], s["warps"]),
            "warp_union": mean(s["warp_union"], s["warps"])}


def band_rows_per_lane(cfg, cid, cell_start, m: int) -> dict:
    """``band_stats`` of the sublane band kernels (``sweeps_t.band_ranges``
    of the self cids ``cid`` in the candidates' cell-start table
    ``cell_start``, over ``m`` candidate rows: the sorted frame in exact
    mode, the sub frame in capped mode)."""
    from ..ops.sweeps_t import band_ranges

    return band_stats(*band_ranges(cfg, cid, cell_start), m)


def slab_band_rows_per_lane(cfg, band, count: int) -> dict:
    """``band_stats`` of the slab engine's exact band kernels over a rank's
    frozen ``slab_sweeps.SlabBand``: the bands of the ``count`` live own
    rows (cids ``band.cid[:count]``; the dead rows walk nothing) in the
    table of the frame's live rows (compacted rows; own row i is live row
    ``band.nl + i``).  At world size 1 the live rows are the single-chip
    sorted frame, so this equals ``band_rows_per_lane`` of its table."""
    return band_rows_per_lane(cfg, band.cid[:count], band.cell_start,
                              band.rows.shape[0])


def slab_sub_band_rows_per_lane(cfg, band, count: int) -> dict:
    """``band_stats`` of the slab engine's capped band kernels over a rank's
    frozen ``slab_sweeps.SubBand``: the bands of the ``count`` live own rows
    in the table of the sub frame's kept rows (``cell_start[num_cells]`` of
    them; the tail and the own dead rows are walked by no lane).  At world
    size 1 the kept count of each cell is the single-chip sub frame's, so
    this equals ``band_rows_per_lane`` of ``prepare_t``'s capped table."""
    return band_rows_per_lane(cfg, band.cid[:count], band.cell_start,
                              int(band.cell_start[-1]))


def prepass_rows(cfg, cid_sub, cell_start) -> dict:
    """The fused path's sub-frame pre-pass over the S sub rows (self cids
    ``cid_sub``, ``TAIL_CID`` on the unkept tail): its band kernel's
    ``band_stats`` over the kept rows (``cell_start[num_cells]`` of them;
    the tail rows walk nothing) in the sub frame's table ``cell_start``.
    One device: ``prepare_t``'s ``cand_cid`` and ``cell_start``; the slab
    engine: ``cand_cid`` and ``SubBand.cell_start``."""
    kept = int(cell_start[-1])
    return band_rows_per_lane(cfg, cid_sub[:kept], cell_start, kept)


def corner_state(cfg, counts: tuple = (600, 900, 1200), short: int = 40,
                 seed: int = 9):
    """The frame where a table over a slab's raw extended frame walks dead
    rows: a 4-slab state on a cubic grid of 16s cells a side (s =
    ``grid_nx / 16``, nz/4 planes per rank) whose rank 1 holds its
    bottom-corner column end (``counts[0]`` particles from cell (0, 0, 4s)),
    its top-corner one (``counts[1]``, to cell (16s-1, 16s-1, 8s-1): its last
    cell, the own dead run's) and a layer between (``counts[2]``), while
    ranks 0 and 2 hold ``short`` particles each, fewer than ``h_cap``: so
    rank 1's left halo ends in rank 0's dead rows (in the cell (16s-1,
    16s-1, 4s-1), next to rank 1's first) and its right halo in rank 2's.
    Positions uniform in the cells named, velocities 0.01 normal, from
    numpy's generator at ``seed``; a CPU state."""
    import numpy as np

    from ..state import ParticleState

    rng = np.random.default_rng(seed)
    s, c = cfg.grid_nx / 16, cfg.cell_size

    def box(lo, hi, k, dz=(0.0, 0.0)):
        lo = np.asarray(lo, float) * s + (0.0, 0.0, dz[0])
        hi = np.asarray(hi, float) * s + (0.0, 0.0, dz[1])
        return (lo + (hi - lo) * rng.random((k, 3))) * c

    pos = np.concatenate([
        box((0, 0, 4), (3, 3, 6), counts[0], (0.0, -0.1)),    # rank 1
        box((12, 12, 6), (16, 16, 8), counts[1], (0.1, 0.0)),  # rank 1
        box((0, 0, 5), (16, 16, 7), counts[2]),   # rank 1: the layer
        box((10, 10, 2), (16, 16, 4), short),     # rank 0, below rank 1
        box((0, 0, 8), (4, 4, 10), short),        # rank 2, above rank 1
        box((4, 4, 13), (8, 8, 15), short),       # rank 3
    ]).astype(np.float32)
    vel = (0.01 * rng.standard_normal(pos.shape)).astype(np.float32)
    return ParticleState.from_arrays(torch.from_numpy(pos),
                                     torch.from_numpy(vel), cfg=cfg)


def lane_band_rows_per_lane(cfg, p) -> dict:
    """``band_stats`` of the lane band kernels over a ``PreparedLane``
    (``sweeps_lane.band_ranges_lane``: cell bands inside block windows)."""
    from ..ops.sweeps_lane import band_ranges_lane

    return band_stats(*band_ranges_lane(cfg, p.cid, p.cell_start, p.ws, p.wc),
                      p.cid.shape[0])


def _print_band(label: str, band: dict) -> None:
    print(f"band    ({label}): {band['mean']:.1f} rows/lane, max over a "
          f"warp {band['warp_max']:.1f}, warp union {band['warp_union']:.1f}")


def main() -> None:
    from ..models import make_scene
    from ..ops import sweeps_lane, sweeps_t
    from .benchmark import resolve_sweep_settings

    thin = dict(device="cpu", grid_nx=128, grid_ny=128, grid_nz=16)
    # pool heights of the 1M scenes: 13.6 lattice layers on 1.0h cells,
    # 8.68 on 1.25h cells (the pool's footprint is the box floor)
    cfg, st = make_scene("splash", num_particles=124_000,
                         pallas_layout="lane", **thin)
    p = sweeps_lane.prepare_lane(cfg, st)
    _, nc = sweeps_lane.density_lane(cfg, sweeps_lane.density_fields(cfg, p),
                                     p.ws, p.wc, st.n, p.cell_start)
    print(f"lane    (1.0h cells, window {cfg.pallas_window}): "
          f"{lane_rows_per_thread(cfg, p):.1f} rows/thread, "
          f"mean neighbors {nc.double().mean().item():.2f}")
    _print_band("1.0h cells, lane", lane_band_rows_per_lane(cfg, p))
    cfg, st = make_scene("splash", num_particles=124_603, cell_size_factor=1.25,
                         pallas_window_t=208, **thin)
    p = sweeps_t.prepare_t(cfg, st)
    _, nc = sweeps_t.density_sweep_t(cfg, p)
    print(f"sublane (1.25h cells): mean neighbors "
          f"{nc.double().mean().item():.2f}")
    _print_band("1.25h cells, exact",
                band_rows_per_lane(cfg, p.cid, p.cell_start, st.n))
    capped = dict(num_particles=124_603, cell_size_factor=1.25,
                  capped_candidates=4, pallas_window_t=0, capped_fused=True)
    cfg, st = make_scene("splash", **capped, **thin)
    cfg = resolve_sweep_settings(cfg, st, capped)
    p = sweeps_t.prepare_t(cfg, st)
    s_len = p.sub_perm.shape[0]
    _, nc = sweeps_t.density_sweep_t(cfg, p)
    print(f"capped  (1.25h cells, K_c {cfg.capped_candidates}, S {s_len}): "
          f"mean neighbors {nc.double().mean().item():.2f}")
    _print_band("1.25h cells, capped",
                band_rows_per_lane(cfg, p.cid, p.cell_start, s_len))
    print(f"pre-pass (the sub frame over itself, {int(p.cell_start[-1])} "
          f"kept rows)")
    _print_band("1.25h cells, fused pre-pass",
                prepass_rows(cfg, p.cand_cid, p.cell_start))


if __name__ == "__main__":
    main()
