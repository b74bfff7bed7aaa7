"""Exact-mode neighbor sweeps on the cell-sorted frame.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py``
(exact branch; the capped "Subsets" branches and the fused capped sweep are
still to be ported).  ``prepare_t`` bins and sorts the particles and builds
the per-(block, rod) window tables; ``density_sweep_t`` and
``force_sweep_t`` run the two sweep kernels over them.

Each kernel has a wrapper and a plain PyTorch twin here:

* ``density_t`` -> CUDA kernel ``density_kernel_t`` (``csrc/sweep_t.cu``),
  replacing ``_density_kernel_t``; twin ``density_t_plain``;
* ``force_t`` -> CUDA kernel ``force_kernel_t``, replacing
  ``_force_kernel_t``; twin ``force_t_plain``.

A wrapper given CPU tensors computes with the twin; given CUDA tensors it
launches the kernel (built from source on first use) or raises; any other
device raises.  ``<wrapper>.launches`` counts kernel launches.

Differences from the JAX package: cell ids are int32 (the TPU kernels carry
f32 ids, exact below 2^24 cells), window walks stop at the particle count
instead of reading padded rows, and the force sums are direct per-pair sums
(no per-block reference point, no MXU reduction), so accelerations differ
from the TPU's by reassociation only.  Lane groups (``pallas_groups > 1``)
are not ported.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SphConfig, _f32
from ..state import ParticleState
from ..utils import build
from . import physics
from .grid import cell_coords, inverse_order, linear_cell_id, unsort_stacked

SUB = 8      # window starts align down to this many rows
LANE = 128   # padded-frame granule of the JAX package's window tables
# The 9 (dy, dz) stencil rods; rod r's linear-id offset is (dz*ny + dy)*nx.
RODS = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
NRODS = len(RODS)
# pair elements per twin chunk ([blocks, b, s_t] tensors), bounding its memory
_PAIR_BUDGET = 1 << 25


def _blane(cfg: SphConfig) -> int:
    """Sorted particles per block (one CUDA block, one JAX grid step)."""
    return cfg.pallas_block_t or LANE


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _n_pad(cfg: SphConfig, n: int) -> int:
    """The JAX package's padded candidate length: window starts clip to
    ``n_pad - window`` exactly as there, so the tables compare equal."""
    return _round_up(n + cfg.pallas_window_t, LANE)


def rod_deltas(cfg: SphConfig) -> list[int]:
    return [(dz * cfg.grid_ny + dy) * cfg.grid_nx for dy, dz in RODS]


def _validate(cfg: SphConfig) -> None:
    if cfg.compat:
        raise ValueError("the sweeps support default mode only")
    if cfg.capped_candidates:
        raise NotImplementedError("capped_candidates is not ported to the "
                                  "torch package yet")
    if cfg.num_cells >= 1 << 31:
        raise ValueError("cell ids are int32: num_cells must be < 2^31")
    if min(cfg.grid_nx, cfg.grid_ny, cfg.grid_nz) < 3:
        raise ValueError(
            "the rod mask needs grid dims >= 3 in every axis "
            f"(got {cfg.grid_nx}x{cfg.grid_ny}x{cfg.grid_nz})")
    if cfg.pallas_window_t <= 0 or cfg.pallas_window_t % SUB:
        raise ValueError(f"pallas_window_t must be a positive multiple of {SUB}"
                         " (0 = auto is resolved by derive_window_t)")
    if cfg.pallas_groups != 1:
        raise NotImplementedError("pallas_groups > 1 (lane groups) is not "
                                  "ported to the torch package")
    if _blane(cfg) not in (128, 256, 512):
        raise ValueError("pallas_block_t must be 128, 256, or 512")


class PreparedT(NamedTuple):
    """Sorted fields + window tables shared by both sweeps."""

    order: torch.Tensor    # [N] i64: sorted row -> original index
    pos_s: torch.Tensor    # [N, 3] sorted
    vel_s: torch.Tensor    # [N, 3] sorted
    mass_s: torch.Tensor   # [N] sorted
    cid: torch.Tensor      # [N] i32 sorted cell ids
    ws: torch.Tensor       # [nblocks*9] i32 window starts
    wc: torch.Tensor       # [nblocks*9] i32 window chunk counts


def _block_windows_t(cfg: SphConfig, cid_sorted: torch.Tensor, nblocks: int,
                     window: int, n: int, n_pad: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (block, rod): 8-aligned window start + chunk count of ``window``
    rows, flattened in (block, rod) order.

    A block's rod window spans the cells from (first cid + delta - 1) to
    (last cid + delta + 1), looked up in one bincount + cumsum of the sorted
    cids.  Any superset of the true window gives the same sums (the kernels'
    cid mask rejects the extra rows), so the GPU walks the rows
    ``[ws, ws + wc*window)`` directly.
    """
    b = _blane(cfg)
    last = cfg.num_cells - 1
    deltas = torch.tensor(rod_deltas(cfg), dtype=torch.int64,
                          device=cid_sorted.device)
    cid64 = cid_sorted.long()
    blocks = F.pad(cid64, (0, nblocks * b - n), value=last).view(nblocks, b)
    lo = (blocks[:, :1] + deltas - 1).clamp(0, last)
    hi = (blocks[:, -1:] + deltas + 1).clamp(0, last)
    counts = torch.bincount(cid64.clamp(0, cfg.num_cells),
                            minlength=cfg.num_cells + 1)
    cum = F.pad(counts.cumsum(0), (1, 0))
    w_start = cum[lo]
    w_end = cum[hi + 1]
    w_start = (w_start & ~(SUB - 1)).clamp(0, max(n_pad - window, 0))
    w_len = (w_end - w_start).clamp(min=0)
    w_chunks = torch.where(w_len > 0, -(-w_len // window),
                           torch.zeros_like(w_len))
    return (w_start.to(torch.int32).reshape(-1),
            w_chunks.to(torch.int32).reshape(-1))


def derive_window_t(cfg: SphConfig, state: ParticleState,
                    percentile: float = 90.0) -> int:
    """Pick ``pallas_window_t`` from the state's rod-window lengths: the
    given percentile rounded up to 8 rows (at least 64).  Host-side, once
    per run."""
    b = _blane(cfg)
    n = state.n
    cid = np.sort(linear_cell_id(cfg, cell_coords(cfg, state.position))
                  .cpu().numpy())
    deltas = np.asarray(rod_deltas(cfg))
    nblocks = -(-n // b)
    cid_p = np.pad(cid, (0, nblocks * b - n), constant_values=cfg.num_cells - 1)
    blocks = cid_p.reshape(nblocks, b)
    lo = np.clip(blocks[:, 0][:, None] + deltas[None, :] - 1,
                 0, cfg.num_cells - 1)
    hi = np.clip(blocks[:, -1][:, None] + deltas[None, :] + 1,
                 0, cfg.num_cells - 1)
    a = np.searchsorted(cid, lo.ravel(), side="left")
    e = np.searchsorted(cid, hi.ravel(), side="right")
    lens = np.maximum(e - a, 0)
    lens = lens[lens > 0]
    if lens.size == 0:
        return max(cfg.pallas_window_t, 64) or 64
    w = int(np.percentile(lens, percentile))
    return max(-(-w // SUB) * SUB, 64)


def prepare_t(cfg: SphConfig, state: ParticleState) -> PreparedT:
    """Binning + stable sort by cell id + per-block window tables.

    The sort is stable (ties keep the input order), as the JAX package's
    pair sort is, so ``order`` and the sorted frame match it exactly.
    """
    _validate(cfg)
    n = state.n
    nblocks = -(-n // _blane(cfg))
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position))
    cid_sorted, order = torch.sort(cid, stable=True)
    stacked = torch.cat([state.position, state.velocity, state.mass[:, None]],
                        dim=1)[order]
    ws, wc = _block_windows_t(cfg, cid_sorted, nblocks, cfg.pallas_window_t,
                              n, _n_pad(cfg, n))
    return PreparedT(order=order, pos_s=stacked[:, 0:3].contiguous(),
                     vel_s=stacked[:, 3:6].contiguous(),
                     mass_s=stacked[:, 6].contiguous(),
                     cid=cid_sorted.contiguous(), ws=ws, wc=wc)


def fused_cand_cols(cfg: SphConfig, pos_c: torch.Tensor, vel_c: torch.Tensor,
                    rho_c: torch.Tensor, m_c: torch.Tensor) -> torch.Tensor:
    """[N, 9] force candidate columns: x y z, rimj*vx rimj*vy rimj*vz, rimj,
    mj, mj*pwj with rimj = mj/rhoj and pwj = pj/rhoj^2 (the JAX package's
    lanes 0:3, 4:8, 9, 10; its ones, cid and src lanes serve the MXU and the
    capped mode)."""
    rhoj_inv = physics.safe_inv(rho_c)
    p_j = physics.pressure_from_density(cfg, rho_c)
    rimj = rhoj_inv * m_c
    mjpwj = m_c * (p_j * rhoj_inv * rhoj_inv)
    return torch.cat([pos_c, rimj[:, None] * vel_c, rimj[:, None],
                      m_c[:, None], mjpwj[:, None]], dim=1).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch twins: the same window walk, mask and sums as tensor ops.
# ---------------------------------------------------------------------------

def _window_chunks(cfg: SphConfig, n: int, ws: torch.Tensor, wc: torch.Tensor):
    """Yield ``(blocks, rod, rows, valid)`` for every (block slice, rod,
    chunk) visit of the sweep.  ``rows`` [nb, s_t] are the chunk's candidate
    rows clamped into [0, n); ``valid`` marks rows inside the block's window
    and the particle array."""
    b = _blane(cfg)
    s = cfg.pallas_window_t
    nblocks = -(-n // b)
    ws2 = ws.view(nblocks, NRODS).long()
    wc2 = wc.view(nblocks, NRODS).long()
    lane = torch.arange(s, device=ws.device)
    step = max(1, _PAIR_BUDGET // (b * s))
    for b0 in range(0, nblocks, step):
        blocks = slice(b0, min(nblocks, b0 + step))
        wmax = wc2[blocks].amax(0).tolist()
        for r in range(NRODS):
            for k in range(wmax[r]):
                rows = ws2[blocks, r, None] + k * s + lane
                valid = (k < wc2[blocks, r, None]) & (rows < n)
                yield blocks, r, rows.clamp(max=n - 1), valid


def _self_rows(x: torch.Tensor, nblocks: int, b: int) -> torch.Tensor:
    """[n] -> [nblocks, b, 1], zero-padded: one row per block lane."""
    return F.pad(x, (0, nblocks * b - x.shape[0])).view(nblocks, b, 1)


def _pair_mask(cfg, rows, valid, cid, ci, own, delta, d2) -> torch.Tensor:
    """|cid_j - cid_i - delta| <= 1, j != i, d^2 < h^2 on [nb, b, s_t]."""
    dc = cid[rows][:, None, :] - ci - delta
    return ((dc.abs() <= 1) & (rows[:, None, :] != own)
            & valid[:, None, :] & (d2 < cfg.h2))


def density_t_plain(cfg: SphConfig, pos_s: torch.Tensor, mass_s: torch.Tensor,
                    cid: torch.Tensor, ws: torch.Tensor, wc: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Twin of the density kernel: (rho [N] f32, ncount [N] i32)."""
    n = pos_s.shape[0]
    b = _blane(cfg)
    nblocks = -(-n // b)
    dev = pos_s.device
    xi, yi, zi = (_self_rows(pos_s[:, c], nblocks, b) for c in range(3))
    ci = _self_rows(cid, nblocks, b)
    own = torch.arange(nblocks * b, device=dev).view(nblocks, b, 1)
    deltas = rod_deltas(cfg)
    scale2 = _f32(cfg.sim_scale * cfg.sim_scale)
    rho = torch.zeros(nblocks, b, dtype=torch.float32, device=dev)
    count = torch.zeros(nblocks, b, dtype=torch.int32, device=dev)
    for blocks, r, rows, valid in _window_chunks(cfg, n, ws, wc):
        pj = pos_s[rows]                                   # [nb, s_t, 3]
        dx = pj[:, None, :, 0] - xi[blocks]
        dy = pj[:, None, :, 1] - yi[blocks]
        dz = pj[:, None, :, 2] - zi[blocks]
        d2 = dx * dx + dy * dy + dz * dz
        mask = _pair_mask(cfg, rows, valid, cid, ci[blocks], own[blocks],
                          deltas[r], d2)
        t = cfg.h_scaled2 - d2 * scale2
        w3 = cfg.poly6_norm * t * t * t
        mw = mass_s[rows][:, None, :] * w3
        rho[blocks] += torch.where(mask, mw, torch.zeros_like(mw)).sum(-1)
        count[blocks] += mask.sum(-1, dtype=torch.int32)
    rho = rho.view(-1)[:n]
    if cfg.include_self_density:
        h2s = cfg.h_scaled2
        rho = rho + mass_s * cfg.poly6_norm * h2s * h2s * h2s
    return rho, count.view(-1)[:n]


def force_t_plain(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
                  rho_s: torch.Tensor, cand: torch.Tensor, cid: torch.Tensor,
                  ws: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """Twin of the force kernel: hydro acceleration [N, 3] f32."""
    n = pos_s.shape[0]
    b = _blane(cfg)
    nblocks = -(-n // b)
    dev = pos_s.device
    xi, yi, zi = (_self_rows(pos_s[:, c], nblocks, b) for c in range(3))
    vi = [_self_rows(vel_s[:, c], nblocks, b) for c in range(3)]
    rhoi = F.pad(rho_s, (0, nblocks * b - n), value=1.0).view(nblocks, b, 1)
    ci = _self_rows(cid, nblocks, b)
    own = torch.arange(nblocks * b, device=dev).view(nblocks, b, 1)
    deltas = rod_deltas(cfg)
    h = cfg.h_scaled
    scale = _f32(cfg.sim_scale)
    eps = _f32(cfg.pressure_softening)
    rhoi_inv = physics.safe_inv(rhoi)
    pw_i = (rhoi - _f32(cfg.rho0)) * _f32(cfg.stiffness) * rhoi_inv * rhoi_inv
    # [6, nblocks, b]: pressure sums (x, y, z), then viscosity sums (x, y, z)
    sums = torch.zeros(6, nblocks, b, dtype=torch.float32, device=dev)
    for blocks, r, rows, valid in _window_chunks(cfg, n, ws, wc):
        cj = cand[rows]                                    # [nb, s_t, 9]
        col = [cj[:, None, :, c] for c in range(9)]
        dxyz = (col[0] - xi[blocks], col[1] - yi[blocks], col[2] - zi[blocks])
        d2 = dxyz[0] * dxyz[0] + dxyz[1] * dxyz[1] + dxyz[2] * dxyz[2]
        mask = _pair_mask(cfg, rows, valid, cid, ci[blocks], own[blocks],
                          deltas[r], d2)
        zero = torch.zeros_like(d2)
        d = torch.sqrt(d2) * scale
        hd = torch.where(mask, h - d, zero)
        num = (hd * hd) * (col[7] * pw_i[blocks] + col[8])
        center = num / (d + eps) * scale
        for a in range(3):
            sums[a, blocks] -= torch.where(mask, dxyz[a] * center, zero).sum(-1)
            vis = (col[3 + a] - vi[a][blocks] * col[6]) * hd
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
    """Build (first use) and bind ``csrc/sweep_t.cu``."""
    lib = build.load_library("sweep_t")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sph_density_t.argtypes = [p] * 7 + [i] * 6 + [f] * 4 + [p]
    lib.sph_density_t.restype = i
    lib.sph_force_t.argtypes = [p] * 8 + [i] * 5 + [f] * 8 + [p]
    lib.sph_force_t.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


def _use_plain(x: torch.Tensor) -> bool:
    """CPU tensors take the twin, CUDA tensors the kernel; nothing else."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"sweep kernels run on cuda (twin on cpu), got a "
                     f"tensor on {x.device}")


def _check(device: torch.device, **specs) -> None:
    """Each spec is (tensor, dtype, shape): the kernels take contiguous
    tensors on one device, of exactly these types and shapes."""
    for name, (t, dtype, shape) in specs.items():
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor of shape {shape} "
                f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _raise_on(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.sph_error_string(err).decode()})")


def _tables(cfg: SphConfig, n: int, pos_s, cid, ws, wc) -> dict:
    """The specs every sweep kernel shares: positions, cids, window tables."""
    nt = -(-n // _blane(cfg)) * NRODS
    return dict(pos_s=(pos_s, torch.float32, (n, 3)),
                cid=(cid, torch.int32, (n,)),
                ws=(ws, torch.int32, (nt,)), wc=(wc, torch.int32, (nt,)))


def density_t(cfg: SphConfig, pos_s: torch.Tensor, mass_s: torch.Tensor,
              cid: torch.Tensor, ws: torch.Tensor, wc: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho [N] f32, ncount [N] i32) of the sorted particles."""
    if _use_plain(pos_s):
        return density_t_plain(cfg, pos_s, mass_s, cid, ws, wc)
    n, dev = pos_s.shape[0], pos_s.device
    _check(dev, mass_s=(mass_s, torch.float32, (n,)),
           **_tables(cfg, n, pos_s, cid, ws, wc))
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    ncount = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernels()
    err = lib.sph_density_t(
        pos_s.data_ptr(), mass_s.data_ptr(), cid.data_ptr(), ws.data_ptr(),
        wc.data_ptr(), rho.data_ptr(), ncount.data_ptr(),
        n, _blane(cfg), cfg.pallas_window_t, cfg.grid_nx, cfg.grid_ny,
        int(cfg.include_self_density), cfg.h2, cfg.h_scaled2,
        _f32(cfg.sim_scale * cfg.sim_scale), cfg.poly6_norm,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "density_kernel_t")
    density_t.launches += 1
    return rho, ncount


density_t.launches = 0


def force_t(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
            rho_s: torch.Tensor, cand: torch.Tensor, cid: torch.Tensor,
            ws: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """Hydro acceleration [N, 3] f32 of the sorted particles; ``cand`` is
    ``fused_cand_cols`` of the candidates (the same sorted frame)."""
    if _use_plain(pos_s):
        return force_t_plain(cfg, pos_s, vel_s, rho_s, cand, cid, ws, wc)
    n, dev = pos_s.shape[0], pos_s.device
    _check(dev, vel_s=(vel_s, torch.float32, (n, 3)),
           rho_s=(rho_s, torch.float32, (n,)),
           cand=(cand, torch.float32, (n, 9)),
           **_tables(cfg, n, pos_s, cid, ws, wc))
    acc = torch.empty(n, 3, dtype=torch.float32, device=dev)
    lib = _kernels()
    err = lib.sph_force_t(
        pos_s.data_ptr(), vel_s.data_ptr(), rho_s.data_ptr(), cand.data_ptr(),
        cid.data_ptr(), ws.data_ptr(), wc.data_ptr(), acc.data_ptr(),
        n, _blane(cfg), cfg.pallas_window_t, cfg.grid_nx, cfg.grid_ny,
        cfg.h2, cfg.h_scaled, _f32(cfg.sim_scale),
        _f32(cfg.pressure_softening), _f32(cfg.stiffness), _f32(cfg.rho0),
        _f32(cfg.viscosity), cfg.visc_lap_norm,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "force_kernel_t")
    force_t.launches += 1
    return acc


force_t.launches = 0


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def density_sweep_t(cfg: SphConfig, p: PreparedT
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho_s, ncount_s) in sorted order."""
    return density_t(cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)


def force_sweep_t(cfg: SphConfig, p: PreparedT, rho_s: torch.Tensor
                  ) -> torch.Tensor:
    """acc_s [N, 3] in sorted order (hydro only; gravity/CFL by the caller)."""
    cand = fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_s, p.mass_s)
    return force_t(cfg, p.pos_s, p.vel_s, rho_s, cand, p.cid, p.ws, p.wc)


def sweeps_sorted(cfg: SphConfig, p: PreparedT
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both sweeps + gravity + CFL clamp, all in the sorted frame."""
    rho_s, ncount_s = density_sweep_t(cfg, p)
    acc_s = force_sweep_t(cfg, p, rho_s)
    acc_s = acc_s + physics.central_gravity(cfg, p.pos_s)
    acc_s = acc_s + torch.tensor(cfg.gravity, dtype=torch.float32,
                                 device=acc_s.device)
    return physics.cfl_clamp(cfg, acc_s), rho_s, ncount_s


def compute_step_quantities(cfg: SphConfig, state: ParticleState
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(acc, rho, neighbor_count) in the caller's particle order."""
    p = prepare_t(cfg, state)
    acc_s, rho_s, ncount_s = sweeps_sorted(cfg, p)
    acc, rho, ncount = unsort_stacked(inverse_order(p.order),
                                      [acc_s, rho_s, ncount_s])
    return acc, rho, ncount
