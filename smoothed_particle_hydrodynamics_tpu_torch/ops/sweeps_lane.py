"""Lane-layout neighbor sweeps (``pallas_layout="lane"``), rebinned every
step: counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/pallas_step.py``.

Particles are sorted by linear cell id; every block of ``pallas_block_rows``
consecutive sorted rows walks, for each of the 9 (dy, dz) stencil rods, one
row window of the padded SoA field table: a 128-aligned start and a count of
``pallas_window``-row chunks (``_block_windows``).  A pair (i, j) counts when
``|cid_j - cid_i - delta_rod| <= 1``, ``j != i`` (global rows) and
``d^2 < h^2``.  The density pass sums m_j poly6(d) and the neighbor count;
the force pass, run on fields that carry each row's density, forms p_j and
1/rho_j per pair (where the sublane kernels read precomputed columns).

Two kernels, each with a wrapper and a plain PyTorch twin here:

* ``density_lane`` -> CUDA kernel ``density_band_lane``
  (``csrc/sweep_lane.cu``), replacing ``_density_kernel``; twin
  ``density_lane_plain``;
* ``force_lane`` -> ``force_band_lane``, replacing ``_force_kernel``; twin
  ``force_lane_plain``.

The kernels walk each row's own cell bands (``band_ranges_lane``): per rod,
the rows of cells [cid_i + delta - 1, cid_i + delta + 1] from the frame's
cell-start table ``PreparedLane.cell_start``, intersected with the row's
block window, so they sum the twins' pairs (those the cid mask admits
inside the window) in the twins' order.  A wrapper given CPU tensors
computes with the twin; given CUDA tensors it launches the band kernel
(built from source on first use) or raises, a missing or misshaped table
included.  ``<wrapper>.launches`` counts kernel launches: one each per
step.  ``density_lane_block``/``force_lane_block`` launch the block walks
the band kernels replaced (``density_kernel_lane``, ``force_kernel_lane``),
which no step path runs: the band kernels' bit-equality reference on the
card.

The window table is the JAX package's, value for value, with its limits:
starts align down to 128 rows and clip to ``n_pad - window``; chunk counts
clip to what fits in ``n_pad``, then to 127 (the TPU packed start and count
into one i32), and the chunks cut by that clamp are counted in
``truncated_ranges``.  The port stores starts and counts as two int32
arrays.  Differences from the JAX package: cell ids are int32 (carried in
the field table's last row as int32 bits; the TPU carried them as f32,
exact below 2^24 cells, the port goes to 2^30), the pad rows' cell id is
``grid.NO_CELL`` (-2^30) instead of -10 (whose rod band reaches cell 0 on
some grids), fields are plain [F, n_pad] rows instead of
[n_pad/128, F, 128] tiles, and each kernel launches once over all rows
(the TPU split large grids into several calls to bound its scalar-prefetch
tables).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import SphConfig, _f32
from ..state import ParticleState
from ..utils import build
from . import physics
from .celllist import CellListAux
from .grid import NO_CELL, RODS, build_grid, rod_deltas, unsort
from .launch import check, raise_on, stream, use_plain
from .sweeps_t import LANE, _round_up, _self_rows

CHUNK_CLAMP = 127  # most chunks a (block, rod) window walks
DENSITY_COLS = 4   # x y z m, then the cid row
FORCE_COLS = 8     # x y z vx vy vz m rho, then the cid row
# pair elements per twin chunk ([blocks, b, window] tensors)
_PAIR_BUDGET = 1 << 25


def n_pad(cfg: SphConfig, n: int) -> int:
    """Rows of the field table: n rounded up to 128, plus one window."""
    return _round_up(n, LANE) + cfg.pallas_window


def _validate(cfg: SphConfig) -> None:
    if cfg.compat:
        raise ValueError("pallas backend supports default mode only; compat "
                         "mode is not ported to the torch package yet")
    if cfg.capped_candidates:
        raise ValueError("capped_candidates is implemented in the sublane "
                         "layout (pallas_layout='sublane')")
    if cfg.num_cells >= 1 << 30:
        raise ValueError("cell ids are int32 with a -2^30 pad sentinel: "
                         "num_cells must be < 2^30")
    if min(cfg.grid_nx, cfg.grid_ny, cfg.grid_nz) < 3:
        raise ValueError(
            "pallas backends require grid dims >= 3 in every axis "
            f"(got {cfg.grid_nx}x{cfg.grid_ny}x{cfg.grid_nz}); "
            "use the celllist backend for degenerate grids")
    if cfg.pallas_window <= 0 or cfg.pallas_window % LANE:
        raise ValueError(f"pallas_window must be a positive multiple of {LANE}")
    b = cfg.pallas_block_rows
    if b % 32 or not 32 <= b <= 1024:
        raise ValueError("pallas_block_rows must be a multiple of 32 in "
                         "[32, 1024] (one CUDA thread per row)")


def _block_windows(cfg: SphConfig, cid_sorted: torch.Tensor,
                   cell_start: torch.Tensor, cell_end: torch.Tensor,
                   nblocks: int, block_rows: int, window: int, n: int,
                   n_pad: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (block, rod), flattened in (block, rod) order: (window start
    [nblocks*9] i32, chunk count [nblocks*9] i32, the chunks cut by the
    127 clamp summed, i32).

    Rod delta of a block covering cells [c_first, c_last] spans
    [cell_start[c_first + delta - 1], cell_end[c_last + delta + 1]), the
    cells clipped into the grid; the start aligns down to 128 rows and
    clips to ``n_pad - window``, so every chunk read stays inside n_pad."""
    last = cfg.num_cells - 1
    deltas = torch.tensor(rod_deltas(cfg), dtype=torch.int64,
                          device=cid_sorted.device)
    blocks = F.pad(cid_sorted.long(), (0, nblocks * block_rows - n),
                   value=last).view(nblocks, block_rows)
    lo = (blocks[:, :1] + deltas - 1).clamp(0, last)
    hi = (blocks[:, -1:] + deltas + 1).clamp(0, last)
    w_start = cell_start.long()[lo]
    w_end = cell_end.long()[hi]
    w_start = (w_start & ~(LANE - 1)).clamp(0, max(n_pad - window, 0))
    w_len = (w_end - w_start).clamp(min=0)
    max_chunks = max((n_pad - window) // window + 1, 1)
    w_chunks = torch.where(w_len > 0, (-(-w_len // window)).clamp(1, max_chunks),
                           torch.zeros_like(w_len))
    clamped = (w_chunks - CHUNK_CLAMP).clamp(min=0).sum().to(torch.int32)
    return (w_start.to(torch.int32).reshape(-1),
            w_chunks.clamp(max=CHUNK_CLAMP).to(torch.int32).reshape(-1),
            clamped)


def band_ranges_lane(cfg: SphConfig, cid: torch.Tensor,
                     cell_start: torch.Tensor, ws: torch.Tensor,
                     wc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """([n, 9], [n, 9]) i64: rows [a, e) that the band kernels test for each
    sorted row and rod (empty where e <= a): the cell band
    ``[cell_start[c - 1], cell_start[c + 2])``, c = cid_i + delta, its cell
    range clamped to [0, num_cells], intersected with the row's block window
    ``[ws, ws + wc * pallas_window)``."""
    deltas = torch.tensor(rod_deltas(cfg), dtype=torch.int64,
                          device=cid.device)
    c = cid.long()[:, None] + deltas
    cs = cell_start.long()
    blk = torch.arange(cid.shape[0], device=cid.device) // cfg.pallas_block_rows
    w0 = ws.view(-1, len(RODS)).long()[blk]
    w1 = w0 + wc.view(-1, len(RODS)).long()[blk] * cfg.pallas_window
    return (torch.maximum(cs[(c - 1).clamp(0, cfg.num_cells)], w0),
            torch.minimum(cs[(c + 2).clamp(0, cfg.num_cells)], w1))


class PreparedLane(NamedTuple):
    """Sorted fields, window tables and cell-start table of one step."""

    order: torch.Tensor             # [N] i64: sorted row -> original index
    pos_s: torch.Tensor             # [N, 3] sorted
    vel_s: torch.Tensor             # [N, 3] sorted
    mass_s: torch.Tensor            # [N] sorted
    cid: torch.Tensor               # [N] i32 sorted cell ids
    ws: torch.Tensor                # [nblocks*9] i32 window starts
    wc: torch.Tensor                # [nblocks*9] i32 chunk counts (<= 127)
    cell_start: torch.Tensor        # [C+1] i32: first row of each cell, N
    truncated_ranges: torch.Tensor  # i32: chunks cut by the 127 clamp
    overflow_cells: torch.Tensor    # i32: cells over cfg.cell_capacity


def prepare_lane(cfg: SphConfig, state: ParticleState) -> PreparedLane:
    """Binning, stable sort (one stacked row gather), window tables and the
    cell-start table (``cell_end`` with a 0 in front)."""
    _validate(cfg)
    n = state.n
    b = cfg.pallas_block_rows
    g = build_grid(cfg, state.position)
    stacked = torch.cat([state.position, state.velocity, state.mass[:, None]],
                        dim=1)[g.order]
    ws, wc, clamped = _block_windows(cfg, g.cell_ids, g.cell_start, g.cell_end,
                                     -(-n // b), b, cfg.pallas_window, n,
                                     n_pad(cfg, n))
    return PreparedLane(
        order=g.order, pos_s=stacked[:, 0:3], vel_s=stacked[:, 3:6],
        mass_s=stacked[:, 6], cid=g.cell_ids, ws=ws, wc=wc,
        cell_start=F.pad(g.cell_end, (1, 0)), truncated_ranges=clamped,
        overflow_cells=g.overflow_cells)


def lane_fields(cfg: SphConfig, columns: list[torch.Tensor],
                cid: torch.Tensor) -> torch.Tensor:
    """[len(columns) + 1, n_pad] f32 field table: the [N] columns padded
    with 0, then the cell ids as int32 bits padded with ``NO_CELL``."""
    n = cid.shape[0]
    k = len(columns)
    f = torch.zeros(k + 1, n_pad(cfg, n), dtype=torch.float32,
                    device=cid.device)
    f[:k, :n] = torch.stack(columns)
    cid_row = f[k].view(torch.int32)
    cid_row[:n] = cid
    cid_row[n:] = NO_CELL
    return f


def density_fields(cfg: SphConfig, p: PreparedLane) -> torch.Tensor:
    return lane_fields(cfg, [p.pos_s[:, 0], p.pos_s[:, 1], p.pos_s[:, 2],
                             p.mass_s], p.cid)


def force_fields(cfg: SphConfig, p: PreparedLane, rho_s: torch.Tensor
                 ) -> torch.Tensor:
    return lane_fields(cfg, [p.pos_s[:, 0], p.pos_s[:, 1], p.pos_s[:, 2],
                             p.vel_s[:, 0], p.vel_s[:, 1], p.vel_s[:, 2],
                             p.mass_s, rho_s], p.cid)


# ---------------------------------------------------------------------------
# Plain PyTorch twins: the same window walk, mask and sums as tensor ops.
# ---------------------------------------------------------------------------

def _pairs(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
           wc: torch.Tensor, n: int):
    """Yield ``(blocks, rows, dxyz, d2, mask)`` for every (block slice, rod,
    chunk) visit: rows [nb, window] of the chunk, the self-minus-candidate
    offsets [nb, b, window], d^2 = dx*dx + dy*dy + dz*dz and the pair mask
    (rod band, j != i, chunk inside the block's window, d^2 < h^2)."""
    b, s = cfg.pallas_block_rows, cfg.pallas_window
    nblocks = -(-n // b)
    cid_row = fields.shape[0] - 1
    cid = fields[cid_row].view(torch.int32)
    xyz = [_self_rows(fields[c, :n], nblocks, b) for c in range(3)]
    ci = _self_rows(cid[:n], nblocks, b)
    own = torch.arange(nblocks * b, device=fields.device).view(nblocks, b, 1)
    ws2 = ws.view(nblocks, len(RODS)).long()
    wc2 = wc.view(nblocks, len(RODS)).long()
    lane = torch.arange(s, device=fields.device)
    last = fields.shape[1] - 1
    deltas = rod_deltas(cfg)
    step = max(1, _PAIR_BUDGET // (b * s))
    for b0 in range(0, nblocks, step):
        blocks = slice(b0, min(nblocks, b0 + step))
        wmax = wc2[blocks].amax(0).tolist()
        for r in range(len(RODS)):
            for k in range(wmax[r]):
                # rows past a block's own chunk count may leave the table;
                # they are clamped here and masked out by `valid`
                rows = (ws2[blocks, r, None] + k * s + lane).clamp(max=last)
                valid = (k < wc2[blocks, r, None])[:, None, :]
                dxyz = [xyz[c][blocks] - fields[c][rows][:, None, :]
                        for c in range(3)]
                d2 = dxyz[0] * dxyz[0] + dxyz[1] * dxyz[1] + dxyz[2] * dxyz[2]
                # two-sided, not abs(): a wrapped difference to NO_CELL may
                # be -2^31
                dc = cid[rows][:, None, :] - ci[blocks] - deltas[r]
                mask = ((dc >= -1) & (dc <= 1)
                        & (rows[:, None, :] != own[blocks]) & valid
                        & (d2 < cfg.h2))
                yield blocks, rows, dxyz, d2, mask


def density_lane_plain(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
                       wc: torch.Tensor, n: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Twin of the density kernel: (rho [n] f32, ncount [n] i32) of the
    sorted rows, from the [5, n_pad] density field table."""
    b = cfg.pallas_block_rows
    nblocks = -(-n // b)
    rho = torch.zeros(nblocks, b, dtype=torch.float32, device=fields.device)
    count = torch.zeros(nblocks, b, dtype=torch.int32, device=fields.device)
    scale2 = _f32(cfg.sim_scale * cfg.sim_scale)
    for blocks, rows, _, d2, mask in _pairs(cfg, fields, ws, wc, n):
        t = cfg.h_scaled2 - d2 * scale2
        w = cfg.poly6_norm * t * t * t
        mw = fields[3][rows][:, None, :] * w
        rho[blocks] += torch.where(mask, mw, torch.zeros_like(mw)).sum(-1)
        count[blocks] += mask.sum(-1, dtype=torch.int32)
    return (physics.self_density(cfg, rho.view(-1)[:n], fields[3, :n]),
            count.view(-1)[:n])


def force_lane_plain(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
                     wc: torch.Tensor, n: int) -> torch.Tensor:
    """Twin of the force kernel: hydro acceleration [n, 3] f32 of the
    sorted rows, from the [9, n_pad] force field table (row 7: rho)."""
    b = cfg.pallas_block_rows
    nblocks = -(-n // b)
    h = cfg.h_scaled
    scale = _f32(cfg.sim_scale)
    eps = _f32(cfg.pressure_softening)
    k = _f32(cfg.stiffness)
    rho0 = _f32(cfg.rho0)
    vi = [_self_rows(fields[3 + c, :n], nblocks, b) for c in range(3)]
    rhoi = _self_rows(fields[7, :n], nblocks, b)
    rhoi_inv = physics.safe_inv(rhoi)
    pw_i = (rhoi - rho0) * k * rhoi_inv * rhoi_inv
    # sums[0:3]: pressure sums (x, y, z); sums[3:6]: viscosity sums
    sums = torch.zeros(6, nblocks, b, dtype=torch.float32, device=fields.device)
    for blocks, rows, dxyz, d2, mask in _pairs(cfg, fields, ws, wc, n):
        vj, mj, rhoj = ([fields[3 + c][rows][:, None, :] for c in range(3)],
                        fields[6][rows][:, None, :],
                        fields[7][rows][:, None, :])
        zero = torch.zeros_like(d2)
        d = torch.sqrt(d2) * scale
        hd = torch.where(mask, h - d, zero)
        p_j = (rhoj - rho0) * k
        rhoj_inv = physics.safe_inv(rhoj)
        pweight = pw_i[blocks] + p_j * rhoj_inv * rhoj_inv
        center = (hd * hd) * (mj * pweight) / (d + eps) * scale
        vweight = hd * (rhoj_inv * mj)
        for a in range(3):
            sums[a, blocks] += torch.where(mask, dxyz[a] * center,
                                           zero).sum(-1)
            vis = (vj[a] - vi[a][blocks]) * vweight
            sums[3 + a, blocks] += torch.where(mask, vis, zero).sum(-1)
    mu_rhoi = _f32(cfg.viscosity) * rhoi_inv[..., 0]
    norm = cfg.visc_lap_norm
    acc = torch.stack([mu_rhoi * sums[3 + a] * norm + sums[a] * norm
                       for a in range(3)], dim=-1)
    return acc.view(-1, 3)[:n]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/sweep_lane.cu``."""
    lib = build.load_library("sweep_lane")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sph_density_lane.argtypes = [p] * 6 + [i] * 9 + [f] * 4 + [p]
    lib.sph_density_lane.restype = i
    lib.sph_force_lane.argtypes = [p] * 5 + [i] * 8 + [f] * 8 + [p]
    lib.sph_force_lane.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


def _specs(cfg: SphConfig, fields, rows: int, ws, wc, n: int) -> dict:
    nt = -(-n // cfg.pallas_block_rows) * len(RODS)
    return dict(fields=(fields, torch.float32, (rows, n_pad(cfg, n))),
                ws=(ws, torch.int32, (nt,)), wc=(wc, torch.int32, (nt,)))


def _table_spec(cfg: SphConfig, cell_start) -> dict:
    if cell_start is None:
        raise ValueError("the lane band kernels need the frame's cell-start "
                         "table (PreparedLane.cell_start)")
    return dict(cell_start=(cell_start, torch.int32, (cfg.num_cells + 1,)))


def _launch_density(cfg: SphConfig, fields, ws, wc, n: int, cell_start,
                    kernel: str) -> tuple[torch.Tensor, torch.Tensor]:
    """One density launch: the band walk over ``cell_start``, or the block
    walk when it is None."""
    dev = fields.device
    check(dev, **_specs(cfg, fields, DENSITY_COLS + 1, ws, wc, n),
          **({} if cell_start is None else _table_spec(cfg, cell_start)))
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    ncount = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernels()
    err = lib.sph_density_lane(
        fields.data_ptr(), ws.data_ptr(), wc.data_ptr(),
        None if cell_start is None else cell_start.data_ptr(),
        rho.data_ptr(), ncount.data_ptr(), n, fields.shape[1],
        cfg.pallas_block_rows, cfg.pallas_window, cfg.grid_nx, cfg.grid_ny,
        cfg.num_cells, int(cfg.include_self_density),
        int(cell_start is not None), cfg.h2, cfg.h_scaled2,
        _f32(cfg.sim_scale * cfg.sim_scale), cfg.poly6_norm, stream(dev))
    raise_on(lib, err, kernel)
    return rho, ncount


def _launch_force(cfg: SphConfig, fields, ws, wc, n: int, cell_start,
                  kernel: str) -> torch.Tensor:
    """One force launch: the band walk over ``cell_start``, or the block
    walk when it is None."""
    dev = fields.device
    check(dev, **_specs(cfg, fields, FORCE_COLS + 1, ws, wc, n),
          **({} if cell_start is None else _table_spec(cfg, cell_start)))
    acc = torch.empty(n, 3, dtype=torch.float32, device=dev)
    lib = _kernels()
    err = lib.sph_force_lane(
        fields.data_ptr(), ws.data_ptr(), wc.data_ptr(),
        None if cell_start is None else cell_start.data_ptr(),
        acc.data_ptr(), n, fields.shape[1], cfg.pallas_block_rows,
        cfg.pallas_window, cfg.grid_nx, cfg.grid_ny, cfg.num_cells,
        int(cell_start is not None), cfg.h2, cfg.h_scaled, _f32(cfg.sim_scale),
        _f32(cfg.pressure_softening), _f32(cfg.stiffness), _f32(cfg.rho0),
        _f32(cfg.viscosity), cfg.visc_lap_norm, stream(dev))
    raise_on(lib, err, kernel)
    return acc


def density_lane(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
                 wc: torch.Tensor, n: int,
                 cell_start: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho [n] f32, ncount [n] i32) of the sorted rows from the density
    field table (``density_fields``).  The kernel walks each row's cell
    bands (``cell_start``, required on the card) inside its block windows,
    the twin the block windows (``ws``, ``wc``)."""
    if use_plain(fields):
        return density_lane_plain(cfg, fields, ws, wc, n)
    _table_spec(cfg, cell_start)  # no table raises: never the block walk
    out = _launch_density(cfg, fields, ws, wc, n, cell_start,
                          "density_band_lane")
    density_lane.launches += 1
    return out


def force_lane(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
               wc: torch.Tensor, n: int,
               cell_start: torch.Tensor | None = None) -> torch.Tensor:
    """Hydro acceleration [n, 3] f32 of the sorted rows from the force
    field table (``force_fields``); the kernel walks the cell bands
    (``cell_start``, required on the card), the twin the block windows."""
    if use_plain(fields):
        return force_lane_plain(cfg, fields, ws, wc, n)
    _table_spec(cfg, cell_start)  # no table raises: never the block walk
    out = _launch_force(cfg, fields, ws, wc, n, cell_start, "force_band_lane")
    force_lane.launches += 1
    return out


def density_lane_block(cfg: SphConfig, fields: torch.Tensor,
                       ws: torch.Tensor, wc: torch.Tensor, n: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The block walk ``density_kernel_lane`` on CUDA tensors: the band
    kernel's bit-equality reference and "before" time (``chip_smoke.py``);
    no step path launches it and it counts no launches."""
    return _launch_density(cfg, fields, ws, wc, n, None,
                           "density_kernel_lane")


def force_lane_block(cfg: SphConfig, fields: torch.Tensor, ws: torch.Tensor,
                     wc: torch.Tensor, n: int) -> torch.Tensor:
    """The block walk ``force_kernel_lane`` on CUDA tensors (as
    ``density_lane_block``)."""
    return _launch_force(cfg, fields, ws, wc, n, None, "force_kernel_lane")


WRAPPERS = (density_lane, force_lane)
for _w in WRAPPERS:
    _w.launches = 0


def compute_step_quantities(cfg: SphConfig, state: ParticleState
                            ) -> tuple[torch.Tensor, torch.Tensor, CellListAux]:
    """(acc, rho, aux) in the caller's particle order: bin and sort, the
    density pass, the force pass on fields carrying that density, central
    and uniform gravity, the CFL clamp, and a scatter back to the caller's
    order.  ``aux`` counts the cells over ``cell_capacity`` and the chunks
    the 127 clamp cut."""
    p = prepare_lane(cfg, state)
    n = state.n
    rho_s, ncount_s = density_lane(cfg, density_fields(cfg, p), p.ws, p.wc, n,
                                   p.cell_start)
    acc_s = force_lane(cfg, force_fields(cfg, p, rho_s), p.ws, p.wc, n,
                       p.cell_start)
    acc_s = acc_s + physics.central_gravity(cfg, p.pos_s)
    acc_s = acc_s + torch.tensor(cfg.gravity, dtype=torch.float32,
                                 device=acc_s.device)
    acc_s = physics.cfl_clamp(cfg, acc_s)
    aux = CellListAux(neighbor_count=unsort(p.order, ncount_s),
                      overflow_cells=p.overflow_cells,
                      truncated_ranges=p.truncated_ranges)
    return unsort(p.order, acc_s), unsort(p.order, rho_s), aux
