"""Sorted cell-list backend: the portable plain-PyTorch sweeps
(counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/celllist.py``).

Particles are sorted by linear cell id, so x-adjacent cells are contiguous
and each particle's neighborhood is a few contiguous row ranges: 9 for the
27-cell stencil, 4 for the octant stencil (valid with 2h cells, where the
half space is picked by the particle's offset inside its cell).  Each range
contributes at most ``cfg.range_slice`` candidates; longer ranges are cut
and counted in ``truncated_ranges``.  The sweeps run over row chunks so the
[chunk, ranges * range_slice] candidate tensors stay bounded; results do not
depend on the chunk.  No kernel is involved: the JAX package runs this path
as XLA gathers.  It is the CLI's backend on the CPU and the oracle the
``pallas`` sweeps are checked against (``utils.benchmark.run_parity_check``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SphConfig, _f32
from ..state import ParticleState
from . import physics
from .grid import Grid, build_grid, cell_coords, linear_cell_id, unsort


class CellListAux(NamedTuple):
    """Per-step counters of a sweep backend."""

    neighbor_count: torch.Tensor    # [N] i32 (original particle order)
    overflow_cells: torch.Tensor    # i32: cells over cfg.cell_capacity
    truncated_ranges: torch.Tensor  # i32: candidate ranges cut


def default_chunk(device: torch.device) -> int:
    """Rows per sweep chunk: the JAX package's 1024 on the CPU; 8192 on the
    card, where the [chunk, R*S] candidate tensors still take well under a
    GB and fewer chunks mean fewer launches."""
    return 8192 if device.type == "cuda" else 1024


def derive_range_slice(cfg: SphConfig, state: ParticleState,
                       headroom: float = 1.25) -> int:
    """``range_slice`` from the state's 3-cell x-window occupancies (a
    candidate range is a run of <= 3 x-adjacent cells) with headroom,
    rounded up to 8 (at least 16).  Host-side, once per run."""
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position)).cpu().numpy()
    occ = np.bincount(cid, minlength=cfg.num_cells)
    runs = occ + np.roll(occ, -1) + np.roll(occ, 1)
    need = int(runs.max())
    return max(-(-int(need * headroom) // 8) * 8, 16)


def _shift(a: torch.Tensor, d: int) -> torch.Tensor:
    """a[c + d] over a flat [C] array; reads outside the array give 0."""
    if d == 0:
        return a
    out = torch.zeros_like(a)
    if d > 0:
        out[:-d] = a[d:]
    else:
        out[-d:] = a[:d]
    return out


def candidate_ranges(cfg: SphConfig, g: Grid, pos_sorted: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per sorted particle: [N, R] contiguous candidate ranges [start, end).

    A per-cell table of each (dy, dz) rod's pieces (start of x-1, start and
    end of x, end of x+1, with the x edges and out-of-grid rods folded in)
    is built with shifted views and fetched by cell id.  cell27 takes
    [start of x-1, end of x+1) of all 9 rods; octant picks 4 rods by the y/z
    half-space signs (in-cell offset > h) and narrows x by the x sign.
    """
    nx, ny, nz = cfg.grid_nx, cfg.grid_ny, cfg.grid_nz
    c = torch.arange(cfg.num_cells, dtype=torch.int32,
                     device=g.cell_start.device)
    xc, yc, zc = c % nx, (c // nx) % ny, c // (nx * ny)
    full = cfg.neighborhood != "cell27"   # cell27 needs only s_lo / e_hi
    pieces = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            delta = (dz * ny + dy) * nx
            ok = ((yc + dy >= 0) & (yc + dy < ny)
                  & (zc + dz >= 0) & (zc + dz < nz))
            s_0 = _shift(g.cell_start, delta)
            e_0 = _shift(g.cell_end, delta)
            s_lo = torch.where(xc > 0, _shift(g.cell_start, delta - 1), s_0)
            e_hi = torch.where(xc < nx - 1, _shift(g.cell_end, delta + 1), e_0)
            zero = torch.zeros_like(s_0)
            pieces.append(torch.where(ok, s_lo, zero))
            if full:
                pieces.append(torch.where(ok, s_0, zero))
                pieces.append(torch.where(ok, e_0, zero))
            pieces.append(torch.where(ok, e_hi, zero))
    table = torch.stack(pieces, dim=1)                  # [C, 36] or [C, 18]
    rows = table[g.cell_ids.long()].view(-1, 9, 4 if full else 2)

    if cfg.neighborhood == "cell27":
        return rows[:, :, 0].contiguous(), rows[:, :, 1].contiguous()

    orient = pos_sorted - g.coords.to(torch.float32) * _f32(cfg.cell_size)
    s = orient > _f32(cfg.h)                            # [N, 3]: +1 side
    sx, sy, sz = s[:, 0:1], s[:, 1:2], s[:, 2:3]

    def rod(dy_idx: int, dz_idx: int) -> torch.Tensor:  # indices of (-1,0,1)
        return rows[:, dy_idx * 3 + dz_idx, :]          # [N, 4]

    r00 = rod(1, 1)
    r0z = torch.where(sz, rod(1, 2), rod(1, 0))
    ry0 = torch.where(sy, rod(2, 1), rod(0, 1))
    ryz = torch.where(sy, torch.where(sz, rod(2, 2), rod(2, 0)),
                      torch.where(sz, rod(0, 2), rod(0, 0)))
    quad = torch.stack([r00, r0z, ry0, ryz], dim=1)     # [N, 4 rods, 4]
    start = torch.where(sx, quad[:, :, 1], quad[:, :, 0])    # s_0 / s_lo
    end = torch.where(sx, quad[:, :, 3], quad[:, :, 2])      # e_hi / e_0
    return start, end


def _candidate_block(cfg: SphConfig, start: torch.Tensor, end: torch.Tensor,
                     own_idx: torch.Tensor, n_total: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[chunk, R] ranges -> (idx [chunk, R*S] clamped candidate rows, mask
    [chunk, R*S] in-range and not self, truncated [chunk] i32 ranges longer
    than ``range_slice`` per row)."""
    offs = torch.arange(cfg.range_slice, dtype=torch.int32,
                        device=start.device)
    idx = start[:, :, None] + offs
    mask = (idx < end[:, :, None]) & (idx != own_idx[:, None, None])
    truncated = ((end - start) > cfg.range_slice).sum(-1, dtype=torch.int32)
    chunk = start.shape[0]
    return (idx.clamp(0, n_total - 1).view(chunk, -1).long(),
            mask.view(chunk, -1), truncated)


def _dist2(diff: torch.Tensor) -> torch.Tensor:
    """|diff|^2 over the last axis as (x^2 + y^2) + z^2."""
    sq = diff * diff
    return sq[..., 0] + sq[..., 1] + sq[..., 2]


class Prepared(NamedTuple):
    """Sorted-order fields + candidate ranges shared by both sweeps."""

    grid: Grid
    pos_s: torch.Tensor      # [N, 3]
    vel_s: torch.Tensor      # [N, 3]
    mass_s: torch.Tensor     # [N]
    rng_start: torch.Tensor  # [N, R] i32
    rng_end: torch.Tensor    # [N, R] i32


def prepare(cfg: SphConfig, state: ParticleState) -> Prepared:
    """Binning + stable sort (one stacked row gather) + candidate ranges."""
    g = build_grid(cfg, state.position)
    stacked = torch.cat([state.position, state.velocity, state.mass[:, None]],
                        dim=1)[g.order]
    pos_s = stacked[:, 0:3]
    rng_start, rng_end = candidate_ranges(cfg, g, pos_s)
    return Prepared(grid=g, pos_s=pos_s, vel_s=stacked[:, 3:6],
                    mass_s=stacked[:, 6], rng_start=rng_start,
                    rng_end=rng_end)


def density_rows(cfg: SphConfig, pos_s, mass_s, rng_start, rng_end, own_idx,
                 pos_i, m_i, chunk: int = 1024
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Density sweep over a row block: (rho, ncount, truncated) per row.
    ``pos_s``/``mass_s`` are the full sorted arrays (gather sources); the
    other arguments are per row."""
    n_total = pos_s.shape[0]
    rho, ncount, trunc = [], [], []
    for a in range(0, rng_start.shape[0], chunk):
        rows = slice(a, a + chunk)
        idx, mask, truncated = _candidate_block(
            cfg, rng_start[rows], rng_end[rows], own_idx[rows], n_total)
        d2 = _dist2(pos_i[rows, None, :] - pos_s[idx])
        mask = mask & (d2 < cfg.h2)
        d = torch.sqrt(d2) * _f32(cfg.sim_scale)
        rho.append(physics.density_sum(cfg, mass_s[idx], d, mask,
                                       m_self=m_i[rows]))
        ncount.append(mask.sum(-1, dtype=torch.int32))
        trunc.append(truncated)
    return torch.cat(rho), torch.cat(ncount), torch.cat(trunc)


def force_rows(cfg: SphConfig, pos_s, vel_s, mass_s, rho_s, rng_start,
               rng_end, own_idx, pos_i, vel_i, rho_i, chunk: int = 1024
               ) -> torch.Tensor:
    """Force sweep over a row block (needs the full ``rho_s`` of the
    density sweep): hydro + central and uniform gravity, CFL-clamped."""
    n_total = pos_s.shape[0]
    acc = []
    for a in range(0, rng_start.shape[0], chunk):
        rows = slice(a, a + chunk)
        idx, mask, _ = _candidate_block(
            cfg, rng_start[rows], rng_end[rows], own_idx[rows], n_total)
        pos_j = pos_s[idx]
        d2 = _dist2(pos_i[rows, None, :] - pos_j)
        mask = mask & (d2 < cfg.h2)
        d = torch.sqrt(d2) * _f32(cfg.sim_scale)
        acc.append(physics.sph_acceleration(
            cfg, pos_i=pos_i[rows], vel_i=vel_i[rows], rho_i=rho_i[rows],
            pos_j=pos_j, vel_j=vel_s[idx], rho_j=rho_s[idx], m_j=mass_s[idx],
            d=d, mask=mask))
    acc = torch.cat(acc)
    acc = acc + physics.central_gravity(cfg, pos_i)
    acc = acc + torch.tensor(cfg.gravity, dtype=torch.float32,
                             device=acc.device)
    return physics.cfl_clamp(cfg, acc)


def compute_step_quantities(cfg: SphConfig, state: ParticleState,
                            chunk: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, CellListAux]:
    """(acceleration [N, 3], density [N], aux) in the caller's particle
    order: the density sweep, then the force sweep, over the sorted set."""
    p = prepare(cfg, state)
    chunk = chunk or default_chunk(p.pos_s.device)
    own_idx = torch.arange(state.n, dtype=torch.int32, device=p.pos_s.device)
    rho_s, ncount_s, truncated = density_rows(
        cfg, p.pos_s, p.mass_s, p.rng_start, p.rng_end, own_idx, p.pos_s,
        p.mass_s, chunk=chunk)
    acc_s = force_rows(cfg, p.pos_s, p.vel_s, p.mass_s, rho_s, p.rng_start,
                       p.rng_end, own_idx, p.pos_s, p.vel_s, rho_s,
                       chunk=chunk)
    g = p.grid
    aux = CellListAux(neighbor_count=unsort(g.order, ncount_s),
                      overflow_cells=g.overflow_cells,
                      truncated_ranges=truncated.sum(dtype=torch.int32))
    return unsort(g.order, acc_s), unsort(g.order, rho_s), aux
