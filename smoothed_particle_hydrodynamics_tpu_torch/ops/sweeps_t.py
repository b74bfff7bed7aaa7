"""Neighbor sweeps on the cell-sorted frame, exact and capped.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py``.
``prepare_t`` bins and sorts the particles and builds the candidates'
cell-start table; ``sweeps_sorted`` runs the sweeps over them.

Capped ("Subsets") mode, ``cfg.capped_candidates = K_c``: the candidates of
every pair sum come from a SUB FRAME holding at most K_c particles of each
cell (the K_c lowest by a position-free hash, so an unbiased subsample),
compacted to the front and bounded to ``capped_sub_len`` rows; the self rows
stay the full sorted frame.  The cell-start table is the sub frame's, so a
band spans at most 3 cells x K_c rows instead of 3 cells' occupancy.
``capped_reweight`` scales kept masses by occupancy/kept so densities stay
unbiased.  ``capped_fused`` replaces the two sweeps by a density pre-pass
over the sub frame (the candidates' pressures) and one fused pass.

Each kernel has a wrapper and a plain PyTorch twin here:

* ``density_t`` (exact), ``density_capped_t`` (capped) and
  ``density_pre_t`` (the fused path's sub-frame pre-pass) -> CUDA kernel
  ``density_band_t<Excl>`` (``csrc/sweep_t.cu``), replacing the JAX
  package's density kernel; twins ``density_t_plain`` and (the pre-pass on
  the wrapper's own arguments) ``density_pre_t_plain``;
* ``force_t`` (exact) and ``force_capped_t`` -> ``force_band_t<Excl>``,
  replacing its force kernel; twin ``force_t_plain``;
* ``fused_t`` -> ``fused_band_t``, replacing its fused kernel; twin
  ``fused_t_plain``;
* ``band_rows_t`` -> ``band_rows_t``, the counter ``sweeps.rows_tested``
  (``utils/trace.py``; no TPU counterpart); twin ``band_rows_t_plain``;
  K2 also counts, where handed a counter (``stats``), the pairs it sums
  and its warps' drain rounds (``sweeps.force_pairs``,
  ``sweeps.force_rounds``); its twin counts them with
  ``walk_stats.drain_sums``;
* ``fused_cand_cols`` -> ``cand_cols_t`` (``csrc/cand_cols_t.cu``), K2's
  and K3's [M, 9] candidate columns in one pass, the capped gather through
  ``sub_perm`` folded in (no TPU kernel: XLA fuses the JAX package's
  ``fused_cand_cols``); twin ``fused_cand_cols_plain``.

Every sweep walks per-lane cell bands: self row i tests, for each rod, only
the candidate rows of the cells its own cid mask accepts, one contiguous
range of the candidates' cell-start table (``band_ranges``: the sorted
frame's exact, the sub frame's capped and fused).  The JAX kernels walk
each block's whole rod window instead; a band holds exactly the rows of
that window that pass the mask, in the window's order (the CPU tests hold
the bands to the JAX package's own window tables).  A twin walks the same
bands with the same pair mask and terms as its kernel, taking the same
arguments; it sums each band chunk with PyTorch reductions, so its sums
differ from the kernel's by reassociation only.  The pre-pass's unkept tail
rows (self cid ``TAIL_CID``) have empty bands: they get the self term and
count 0; no pair reads a tail row's density.

A wrapper given CPU tensors computes with the twin; given CUDA tensors it
launches the kernel (built from source on first use) or raises; any other
device raises.  ``<wrapper>.launches`` counts kernel launches.

The twins and launch helpers also take ``self_base``: self row i's own id
(the one self-exclusion compares) is ``self_base + i``.  The wrappers here
pass 0; the distributed slab engine (``parallel/slab_sweeps.py``) passes
the live left-halo rows (exact: its candidates are the extended frame's
live rows) or the left-halo width (capped: the sub frame's src rows index
the extended frame).

Differences from the JAX package: cell ids and source rows are int32 (the
TPU kernels carry f32, exact below 2^24 cells and, in capped mode, 2^24
particles), the sweeps walk bands instead of padded windows, the sub
frame's unkept tail rows get cell id ``TAIL_CID`` instead of -10, and the
force sums are direct per-pair sums (no per-block reference point, no MXU
reduction), so accelerations differ from the TPU's by reassociation only.

``pallas_groups``, ``pallas_block_t`` and ``pallas_window_t`` shape the JAX
package's window tables, which no sweep here reads: they are validated as
there and change nothing on this path.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SphConfig, _f32
from ..state import ParticleState
from ..utils import build, trace, walk_stats
from . import physics
from .celllist import CellListAux
from .grid import (NO_CELL, RODS, cell_coords, inverse_order, linear_cell_id,
                   rod_deltas, unsort_stacked)
from .launch import check as _check
from .launch import raise_on as _raise_on
from .launch import stream as _stream
from .launch import use_plain as _use_plain

SUB = 8      # pallas_window_t is a multiple of this many rows
LANE = 128   # the JAX package's row granule: the default pallas_block_t
NRODS = len(RODS)
# Cell id of the sub frame's tail rows (unkept particles beyond the kept
# count).
TAIL_CID = NO_CELL
# pair elements per twin chunk ([rows, band rows] tensors), bounding its
# memory
_PAIR_BUDGET = 1 << 25
# The counter of the lane-rows the self band sweeps test (``band_rows_t``),
# counted by the sweeps that launch them while recording (utils/trace.py).
ROWS_TESTED = "sweeps.rows_tested"
# The counters of K2's pairs and drain rounds (``force_band_t``'s ``stats``:
# per warp and piece, the most hits of any lane), added by the K2 launches
# over a bin made while recording and counted once at the bin.
FORCE_PAIRS, FORCE_ROUNDS = "sweeps.force_pairs", "sweeps.force_rounds"
# The counter of the kept rows of the bins a capped step uses
# (``kept_rows_t``), counted once a step by ``sweeps_sorted``.
KEPT_ROWS = "capped.kept_rows"
# Rows a tile (= threads a block) and blocks an SM of ``cand_cols_t``'s
# persistent grid (csrc/cand_cols_t.cu: kTile, the launch bounds).
CAND_TILE, CAND_BLOCKS_PER_SM = 256, 8
_NO_SPAN = contextlib.nullcontext()
# Self-exclusion modes of the density and force kernels (csrc/sweep_t.cu):
# candidate row vs self row, candidate src vs self row, src vs src.
EXCL_ROW, EXCL_SRC, EXCL_SRC_SRC = 0, 1, 2
# K2's rows a staged piece, by exclusion mode (csrc/sweep_t.cu: kForcePiece)
FORCE_PIECE = {EXCL_ROW: 96, EXCL_SRC: 32}


def _blane(cfg: SphConfig) -> int:
    """Sorted particles per block (one CUDA block, one JAX grid step)."""
    return cfg.pallas_block_t or LANE


def _validate(cfg: SphConfig) -> None:
    if cfg.compat:
        raise ValueError("the sweeps support default mode only")
    if cfg.num_cells >= 1 << 30:
        raise ValueError("cell ids are int32 with a -2^30 tail sentinel: "
                         "num_cells must be < 2^30")
    if min(cfg.grid_nx, cfg.grid_ny, cfg.grid_nz) < 3:
        raise ValueError(
            "the rod mask needs grid dims >= 3 in every axis "
            f"(got {cfg.grid_nx}x{cfg.grid_ny}x{cfg.grid_nz})")
    if cfg.pallas_window_t <= 0 or cfg.pallas_window_t % SUB:
        raise ValueError(f"pallas_window_t must be a positive multiple of {SUB}"
                         " (0 = auto is resolved by derive_window_t)")
    if cfg.pallas_groups not in (1, 2, 4):
        raise ValueError("pallas_groups must be 1, 2, or 4")
    if _blane(cfg) not in (128, 256, 512):
        raise ValueError("pallas_block_t must be 128, 256, or 512")
    if cfg.capped_candidates and cfg.pallas_groups != 1:
        raise ValueError("capped_candidates currently requires pallas_groups=1")


class PreparedT(NamedTuple):
    """Sorted fields + the candidates' cell-start table shared by the sweeps.

    The optional fields exist only in capped mode (``sub_*`` and the sub
    frame's reweighted masses).  ``prepare_t`` always sets ``cell_start``.
    """

    order: torch.Tensor    # [N] i64: sorted row -> original index
    pos_s: torch.Tensor    # [N, 3] sorted
    vel_s: torch.Tensor    # [N, 3] sorted
    mass_s: torch.Tensor   # [N] sorted
    cid: torch.Tensor      # [N] i32 sorted cell ids
    sub_perm: torch.Tensor | None = None     # [S] i32 sub row -> sorted row
    cand_cid: torch.Tensor | None = None     # [S] i32 sub cids (TAIL_CID tail)
    wm_sub: torch.Tensor | None = None       # [S] f32 reweighted cand mass
    sub_dropped: torch.Tensor | None = None  # i32: kept rows beyond S
    # [num_cells + 1] i32, first candidate row of each cell: exact, of the
    # sorted frame (n at the end); capped, of the sub frame (its kept rows
    # within S at the end, so no band reaches the tail)
    cell_start: torch.Tensor | None = None
    # set while recording (utils/trace.py): 0-d i64 lane-rows that one band
    # sweep of the self rows over these bins tests (``band_rows_t``)
    rows_tested: torch.Tensor | None = None
    # set while recording in capped mode: 0-d i64 kept rows of these bins
    # (``kept_rows_t``)
    kept_rows: torch.Tensor | None = None
    # set while recording where K2 runs: [2] i64, the pairs and drain rounds
    # its launches over these bins add (``FORCE_PAIRS``, ``FORCE_ROUNDS``)
    force_stats: torch.Tensor | None = None


SUB_FIELDS = ("sub_perm", "cand_cid", "wm_sub", "sub_dropped")


def cell_start_t(cfg: SphConfig, cid_search: torch.Tensor) -> torch.Tensor:
    """[num_cells + 1] i32: the first row of each cell in the ascending
    candidate cids ``cid_search``, its last entry the rows in cells, from
    one bincount + cumsum.  Search cids >= num_cells (the capped sub frame's
    tail) land in a bucket past the table, so no band reaches them."""
    counts = torch.bincount(cid_search.long().clamp(0, cfg.num_cells),
                            minlength=cfg.num_cells + 1)
    cum = F.pad(counts.cumsum(0), (1, 0))
    return cum[:cfg.num_cells + 1].to(torch.int32)


def band_ranges(cfg: SphConfig, cid: torch.Tensor, cell_start: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """([n, 9], [n, 9]) i64: rows [a, e) of each self row's band per rod,
    the candidate rows j with |cid_j - cid_i - delta| <= 1, as the band
    kernels walk them.  ``cell_start`` is the candidates' table, so the rows
    index the sorted frame in exact mode and the sub frame in capped mode.
    The cell range [cid_i + delta - 1, cid_i + delta + 2) is clamped to
    [0, num_cells], so a band wholly outside the grid is empty."""
    deltas = torch.tensor(rod_deltas(cfg), dtype=torch.int64,
                          device=cid.device)
    c = cid.long()[:, None] + deltas
    cs = cell_start.long()
    return (cs[(c - 1).clamp(0, cfg.num_cells)],
            cs[(c + 2).clamp(0, cfg.num_cells)])


# ---------------------------------------------------------------------------
# Capped sub frame
# ---------------------------------------------------------------------------

def _hash32(idx: torch.Tensor) -> torch.Tensor:
    """Knuth multiplicative hash, 31 bits: the JAX package's wrapping int32
    ``idx * -1640531527 & 0x7FFFFFFF``, computed exactly in int64
    (2654435769 == -1640531527 mod 2^32)."""
    return (idx.long() * 2654435769) & 0x7FFFFFFF


def _hash_bits(cfg: SphConfig) -> int:
    """Spare low bits of an i32 after the cell id; with >= 8 the JAX package
    packs (cid << hb) | hash_top_hb into one sort key."""
    return 31 - max((cfg.num_cells - 1).bit_length(), 1)


def _capped_order(cid: torch.Tensor, hb: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cid_sorted i32, order i64): a stable sort by (cell, hash of the input
    row), so cell members land in hash order and "rank < K_c" is an unbiased
    within-cell subsample.  ``hb >= 8`` is the JAX package's packed key
    (cid, top hb hash bits), ties broken by input row; otherwise its two-key
    (cid, full hash) sort.  Both become one int64 key here."""
    bits = hb if hb >= 8 else 31
    iota = torch.arange(cid.shape[0], device=cid.device)
    key = (cid.long() << bits) | (_hash32(iota) >> (31 - bits))
    key_s, order = torch.sort(key, stable=True)
    return (key_s >> bits).to(torch.int32), order


def _run_rank_occ(cid_sorted: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank within the cid run, run occupancy) per sorted row, from each
    row's run bounds found by binary search in the sorted cids.  (The JAX
    package scans run-boundary flags with cummax/cummin; on an H100,
    torch's cummax and cummin took ~2.7 ms each at 1M rows.)"""
    start = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    end = torch.searchsorted(cid_sorted, cid_sorted, side="right")
    iota = torch.arange(cid_sorted.shape[0], device=cid_sorted.device)
    return iota - start, end - start


def sub_len(cfg: SphConfig, n: int) -> int:
    """Static sub-frame length for capped mode (0 config = full N)."""
    return min(cfg.capped_sub_len or n, n)


def derive_sub_len(cfg: SphConfig, state: ParticleState,
                   margin: float = 1.15) -> int:
    """Host-side: bound the kept-candidate count from the current occupancy
    histogram (sum of min(occ, K_c) per cell) with margin for drift between
    rebins, 128-rounded; 0 (= full N) when that bound is no smaller.
    Overflow is counted (``sub_dropped``), never silent."""
    if not cfg.capped_candidates:
        return 0
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position)).cpu().numpy()
    occ = np.bincount(cid, minlength=cfg.num_cells)
    kept = np.minimum(occ, cfg.capped_candidates).sum()
    v = -(-int(kept * margin + 128) // 128) * 128
    return 0 if v >= state.n else v


def _sub_frame(cfg: SphConfig, cid_sorted: torch.Tensor, mass_s: torch.Tensor
               ) -> tuple[dict, torch.Tensor]:
    """The capped sub frame of a (cell, hash)-sorted frame: its PreparedT
    fields and the cids its cell-start table searches (tail rows at
    num_cells)."""
    n = cid_sorted.shape[0]
    k_c = cfg.capped_candidates
    rank, occ = _run_rank_occ(cid_sorted)
    keep = rank < k_c
    # kept rows to the front, both parts in row (= cid) order
    perm_full = torch.sort((~keep).to(torch.int32), stable=True).indices
    s_len = sub_len(cfg, n)
    sub_perm = perm_full[:s_len].to(torch.int32)
    n_kept = keep.sum()
    sub_dropped = (n_kept - s_len).clamp(min=0).to(torch.int32)
    in_kept = torch.arange(s_len, device=cid_sorted.device) < n_kept
    cid_sub = cid_sorted[sub_perm]
    if cfg.capped_reweight:
        w = occ.to(torch.float32) / occ.clamp(max=k_c).to(torch.float32)
    else:  # reference-faithful truncation: kept masses unscaled
        w = torch.ones_like(mass_s)
    fields = dict(
        sub_perm=sub_perm,
        cand_cid=torch.where(in_kept, cid_sub, TAIL_CID),
        wm_sub=(mass_s * w)[sub_perm],
        sub_dropped=sub_dropped)
    return fields, torch.where(in_kept, cid_sub, cfg.num_cells)


def derive_window_t(cfg: SphConfig, state: ParticleState,
                    percentile: float = 90.0) -> int:
    """Pick ``pallas_window_t`` from the state's rod-window lengths: the
    given percentile rounded up to 8 rows (at least 64).  In capped mode the
    windows index the sub frame, so the per-cell cap is replayed on the
    occupancy histogram.  Host-side, once per run."""
    grows = _blane(cfg) // cfg.pallas_groups
    n = state.n
    cid = np.sort(linear_cell_id(cfg, cell_coords(cfg, state.position))
                  .cpu().numpy())
    deltas = np.asarray(rod_deltas(cfg))
    ngroups = -(-n // grows)
    cid_p = np.pad(cid, (0, ngroups * grows - n),
                   constant_values=cfg.num_cells - 1)
    blocks = cid_p.reshape(ngroups, grows)
    lo = np.clip(blocks[:, 0][:, None] + deltas[None, :] - 1,
                 0, cfg.num_cells - 1)
    hi = np.clip(blocks[:, -1][:, None] + deltas[None, :] + 1,
                 0, cfg.num_cells - 1)
    if cfg.capped_candidates:
        capped = np.minimum(np.bincount(cid, minlength=cfg.num_cells),
                            cfg.capped_candidates)
        cum = np.concatenate([[0], np.cumsum(capped)])
        a = cum[lo.ravel()]
        e = cum[np.minimum(hi.ravel() + 1, cfg.num_cells)]
    else:
        a = np.searchsorted(cid, lo.ravel(), side="left")
        e = np.searchsorted(cid, hi.ravel(), side="right")
    lens = np.maximum(e - a, 0)
    lens = lens[lens > 0]
    if lens.size == 0:
        return max(cfg.pallas_window_t, 64) or 64
    w = int(np.percentile(lens, percentile))
    return max(-(-w // SUB) * SUB, 64)


class SortedFrame(NamedTuple):
    """``sort_frame_t``'s result: the first phase of ``prepare_t``."""

    cid: torch.Tensor      # [N] i32 sorted cell ids
    order: torch.Tensor    # [N] i64 sorted row -> original index
    pos_s: torch.Tensor    # [N, 3] sorted
    vel_s: torch.Tensor    # [N, 3] sorted
    mass_s: torch.Tensor   # [N] sorted


def sort_frame_t(cfg: SphConfig, state: ParticleState) -> SortedFrame:
    """``prepare_t``'s sort: cell ids, the stable (capped: (cell, hash))
    sort and the sorted fields, gathered as one [N, 7] stack that is freed
    here."""
    _validate(cfg)
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position))
    if cfg.capped_candidates:
        cid_sorted, order = _capped_order(cid, _hash_bits(cfg))
    else:
        cid_sorted, order = torch.sort(cid, stable=True)
    stacked = torch.cat([state.position, state.velocity, state.mass[:, None]],
                        dim=1)[order]
    return SortedFrame(cid_sorted, order, stacked[:, 0:3].contiguous(),
                       stacked[:, 3:6].contiguous(),
                       stacked[:, 6].contiguous())


def sub_frame_t(cfg: SphConfig, f: SortedFrame
                ) -> tuple[dict, torch.Tensor]:
    """``prepare_t``'s sub frame: ``_sub_frame``'s fields and the cids the
    cell-start table searches; exact mode, none and the sorted cids."""
    if not cfg.capped_candidates:
        return {}, f.cid
    return _sub_frame(cfg, f.cid, f.mass_s)


def tables_t(cfg: SphConfig, f: SortedFrame, sub: dict,
             cid_search: torch.Tensor) -> PreparedT:
    """``prepare_t``'s table: the candidates' cell starts over the sorted
    frame ``f``, or over the sub frame ``sub`` (its tail rows counted at
    num_cells, past the table's last entry)."""
    return PreparedT(order=f.order, pos_s=f.pos_s, vel_s=f.vel_s,
                     mass_s=f.mass_s, cid=f.cid.contiguous(),
                     cell_start=cell_start_t(cfg, cid_search), **sub)


def prepare_t(cfg: SphConfig, state: ParticleState) -> PreparedT:
    """Binning + stable sort + the candidates' cell-start table (+ the sub
    frame in capped mode): ``sort_frame_t``,
    ``sub_frame_t`` and ``tables_t`` in turn (``lazy._bin`` times each in
    capped mode).

    The sorts are stable, as the JAX package's pair sorts are, so ``order``,
    the sorted frame and (capped) the kept set match it exactly.
    """
    f = sort_frame_t(cfg, state)
    return tables_t(cfg, f, *sub_frame_t(cfg, f))


def fused_cand_cols(cfg: SphConfig, pos_c: torch.Tensor, vel_c: torch.Tensor,
                    rho_c: torch.Tensor, m_c: torch.Tensor,
                    index: torch.Tensor | None = None) -> torch.Tensor:
    """[M, 9] force candidate columns: x y z, rimj*vx rimj*vy rimj*vz, rimj,
    mj, mj*pwj with rimj = mj/rhoj and pwj = pj/rhoj^2 (the JAX package's
    lanes 0:3, 4:8, 9, 10; its ones, cid and src lanes serve the MXU and the
    capped mode, whose cids and srcs ride in their own int32 arrays here).

    With ``index`` (int32 [M]) candidate s takes its position, velocity and
    density from row ``index[s]`` of ``pos_c``, ``vel_c`` and ``rho_c`` and
    its mass from ``m_c[s]``: the capped sub frame's gather folded in.  On
    CPU tensors the twin ``fused_cand_cols_plain`` (after the gather), on
    the card the kernel ``cand_cols_t``, bit-equal to it."""
    if not _use_plain(m_c):
        return cand_cols_t(cfg, pos_c, vel_c, rho_c, m_c, index)
    if index is not None:
        rows = index.long()
        pos_c, vel_c, rho_c = pos_c[rows], vel_c[rows], rho_c[rows]
    return fused_cand_cols_plain(cfg, pos_c, vel_c, rho_c, m_c)


def fused_cand_cols_plain(cfg: SphConfig, pos_c: torch.Tensor,
                          vel_c: torch.Tensor, rho_c: torch.Tensor,
                          m_c: torch.Tensor) -> torch.Tensor:
    """``fused_cand_cols``' twin: the columns as PyTorch ops, row s from
    row s of each input."""
    rhoj_inv = physics.safe_inv(rho_c)
    p_j = physics.pressure_from_density(cfg, rho_c)
    rimj = rhoj_inv * m_c
    mjpwj = m_c * (p_j * rhoj_inv * rhoj_inv)
    return torch.cat([pos_c, rimj[:, None] * vel_c, rimj[:, None],
                      m_c[:, None], mjpwj[:, None]], dim=1).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch twins: the kernels' band walk, mask and sums as tensor ops.
# ---------------------------------------------------------------------------

_NO_TABLE = ("the band sweeps need their candidates' cell-start table "
             "(PreparedT.cell_start, or the slab frame's SlabBand.cell_start "
             "or SubBand.cell_start)")


def _table(cell_start: torch.Tensor | None) -> torch.Tensor:
    """``cell_start``, or a ValueError when it is missing: no sweep falls
    back to a window walk."""
    if cell_start is None:
        raise ValueError(_NO_TABLE)
    return cell_start


def _band_chunks(cfg: SphConfig, pos_s, cid, cell_start, cand_pos,
                 cand_src=None, self_base: int = 0, self_src=None):
    """Yield ``(rows, cols, dxyz, d2, mask)`` for every chunk of the band
    walk: ``rows`` a slice of the self rows, ``cols`` [r, L] the candidate
    rows of their bands in one rod (band order, past a band's end clamped
    into the candidates), the candidate-minus-self offsets, d^2 and the pair
    mask: inside the band, id_j != own_i, d^2 < h^2.  The ids are the
    candidate row vs ``self_base`` + the self row (``cand_src`` None), the
    candidate's src vs the same, or src vs ``self_src``.  The bands are the
    kernels' (``band_ranges``), so the cid mask holds by construction."""
    n, m = pos_s.shape[0], cand_pos.shape[0]
    a, e = band_ranges(cfg, cid, _table(cell_start))
    length = (e - a).clamp(min=0)
    widest = int(length.max()) if n and m else 0
    if widest == 0:
        return
    dev = pos_s.device
    own_all = (torch.arange(self_base, self_base + n, device=dev)
               if self_src is None else self_src.long())
    step = max(1, _PAIR_BUDGET // widest)
    for r0 in range(0, n, step):
        rows = slice(r0, min(n, r0 + step))
        own = own_all[rows, None]
        lmax = length[rows].amax(0).tolist()
        for r in range(NRODS):
            if not lmax[r]:
                continue
            k = torch.arange(lmax[r], device=dev)
            valid = k < length[rows, r, None]
            cols = (a[rows, r, None] + k).clamp(max=m - 1)
            pj = cand_pos[cols]                            # [r, L, 3]
            dxyz = [pj[..., c] - pos_s[rows, c, None] for c in range(3)]
            d2 = dxyz[0] * dxyz[0] + dxyz[1] * dxyz[1] + dxyz[2] * dxyz[2]
            idj = cols if cand_src is None else cand_src[cols]
            mask = valid & (idj != own) & (d2 < cfg.h2)
            yield rows, cols, dxyz, d2, mask


def _density_terms(cfg: SphConfig, d2, mask, m_j):
    """One chunk's rho and count sums (shared by the density and fused
    twins, so their rho agree bit for bit)."""
    t = cfg.h_scaled2 - d2 * _f32(cfg.sim_scale * cfg.sim_scale)
    w3 = cfg.poly6_norm * t * t * t
    mw = m_j * w3
    return (torch.where(mask, mw, torch.zeros_like(mw)).sum(-1),
            mask.sum(-1, dtype=torch.int32))


def density_t_plain(cfg: SphConfig, pos_s: torch.Tensor, mass_s: torch.Tensor,
                    cid: torch.Tensor, cell_start: torch.Tensor | None,
                    cand_pos: torch.Tensor, cand_mass: torch.Tensor,
                    cand_src=None, self_base: int = 0, self_src=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Twin of the density kernel, on its arguments: (rho [N] f32, ncount
    [N] i32) of the self rows over the candidates' bands."""
    n, dev = pos_s.shape[0], pos_s.device
    rho = torch.zeros(n, dtype=torch.float32, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    for rows, cols, _, d2, mask in _band_chunks(
            cfg, pos_s, cid, cell_start, cand_pos, cand_src, self_base,
            self_src):
        r_add, c_add = _density_terms(cfg, d2, mask, cand_mass[cols])
        rho[rows] += r_add
        count[rows] += c_add
    return physics.self_density(cfg, rho, mass_s), count


def density_pre_t_plain(cfg: SphConfig, pos_sub: torch.Tensor,
                        mass_sub: torch.Tensor, wm_sub: torch.Tensor,
                        cid_sub: torch.Tensor, src_sub: torch.Tensor,
                        cell_start: torch.Tensor | None) -> torch.Tensor:
    """Twin of the sub-frame pre-pass (``density_pre_t``): rho [S]."""
    return density_t_plain(*_pre_args(cfg, pos_sub, mass_sub, wm_sub,
                                      cid_sub, src_sub, cell_start))[0]


def _pre_args(cfg, pos_sub, mass_sub, wm_sub, cid_sub, src_sub,
              cell_start) -> tuple:
    """The pre-pass's density-walk arguments: the sub frame over itself,
    self rows with their true masses, candidates with the reweighted ones,
    exclusion src vs src."""
    return (cfg, pos_sub, mass_sub, cid_sub, cell_start, pos_sub, wm_sub,
            src_sub, 0, src_sub)


def _pair_force_terms(cfg: SphConfig, cj, d2, mask):
    """One chunk's per-pair force factors: the candidate columns [r, L] of
    ``cj`` and (h - d) masked to 0 off the pairs, d in simulation units."""
    col = [cj[..., c] for c in range(9)]
    d = torch.sqrt(d2) * _f32(cfg.sim_scale)
    hd = torch.where(mask, cfg.h_scaled - d, torch.zeros_like(d2))
    return col, d, hd


def force_t_plain(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
                  rho_s: torch.Tensor, cand: torch.Tensor, cid: torch.Tensor,
                  cell_start: torch.Tensor | None, cand_src=None,
                  self_base: int = 0, stats: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Twin of the force kernel, on its arguments: hydro acceleration
    [N, 3] f32.  ``cand`` is ``fused_cand_cols`` of the candidates.  With
    ``stats`` ([2] int64), adds the kernel's pairs and drain rounds to it
    (``walk_stats.drain_sums`` of the pairs found, out of the profiler's
    events)."""
    n, dev = pos_s.shape[0], pos_s.device
    scale = _f32(cfg.sim_scale)
    eps = _f32(cfg.pressure_softening)
    rhoi_inv = physics.safe_inv(rho_s)
    pw_i = ((rho_s - _f32(cfg.rho0)) * _f32(cfg.stiffness) * rhoi_inv
            * rhoi_inv)[:, None]
    # sums[0:3]: pressure sums (x, y, z); sums[3:6]: viscosity sums
    sums = torch.zeros(6, n, dtype=torch.float32, device=dev)
    pairs = []
    for rows, cols, dxyz, d2, mask in _band_chunks(
            cfg, pos_s, cid, cell_start, cand[:, 0:3], cand_src, self_base):
        if stats is not None:
            with trace.hidden():
                r, k = mask.nonzero(as_tuple=True)
                pairs.append((r + rows.start, cols[r, k]))
        col, d, hd = _pair_force_terms(cfg, cand[cols], d2, mask)
        zero = torch.zeros_like(d2)
        num = (hd * hd) * (col[7] * pw_i[rows] + col[8])
        center = num / (d + eps) * scale
        for a in range(3):
            sums[a, rows] -= torch.where(mask, dxyz[a] * center, zero).sum(-1)
            vis = (col[3 + a] - vel_s[rows, a, None] * col[6]) * hd
            sums[3 + a, rows] += torch.where(mask, vis, zero).sum(-1)
    if stats is not None:
        with trace.hidden():
            none = torch.zeros(0, dtype=torch.long, device=dev)
            i = torch.cat([none, *(r for r, _ in pairs)])
            j = torch.cat([none, *(c for _, c in pairs)])
            got = walk_stats.drain_sums(
                *band_ranges(cfg, cid, cell_start), i, j,
                FORCE_PIECE[EXCL_ROW if cand_src is None else EXCL_SRC])
            stats += torch.stack([got["pairs"], got["rounds"]])
    mu_rhoi = _f32(cfg.viscosity) * rhoi_inv
    norm = cfg.visc_lap_norm
    return torch.stack([mu_rhoi * sums[3 + a] * norm + sums[a] * norm
                        for a in range(3)], dim=-1)


def fused_t_plain(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
                  mass_s: torch.Tensor, cid: torch.Tensor,
                  cell_start: torch.Tensor | None, cand: torch.Tensor,
                  cand_src: torch.Tensor, self_base: int = 0
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Twin of the fused kernel, on its arguments: (acc [N, 3], rho [N],
    ncount [N]) in one walk over the sub-frame candidates ``cand``
    (``fused_cand_cols`` with the pre-pass densities).  The pressure sum is
    split into pw_i-free P1 (m_j) and P2 (m_j pw_j) sums, combined with the
    walk's own rho."""
    n, dev = pos_s.shape[0], pos_s.device
    scale = _f32(cfg.sim_scale)
    eps = _f32(cfg.pressure_softening)
    rho = torch.zeros(n, dtype=torch.float32, device=dev)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    # sums[0:3]: P1, sums[3:6]: viscosity, sums[6:9]: P2
    sums = torch.zeros(9, n, dtype=torch.float32, device=dev)
    for rows, cols, dxyz, d2, mask in _band_chunks(
            cfg, pos_s, cid, cell_start, cand[:, 0:3], cand_src, self_base):
        col, d, hd = _pair_force_terms(cfg, cand[cols], d2, mask)
        r_add, c_add = _density_terms(cfg, d2, mask, col[7])
        rho[rows] += r_add
        count[rows] += c_add
        zero = torch.zeros_like(d2)
        hd2inv = (hd * hd) / (d + eps) * scale
        c1, c2 = hd2inv * col[7], hd2inv * col[8]
        for a in range(3):
            sums[a, rows] -= torch.where(mask, dxyz[a] * c1, zero).sum(-1)
            sums[6 + a, rows] -= torch.where(mask, dxyz[a] * c2, zero).sum(-1)
            vis = (col[3 + a] - vel_s[rows, a, None] * col[6]) * hd
            sums[3 + a, rows] += torch.where(mask, vis, zero).sum(-1)
    rho = physics.self_density(cfg, rho, mass_s)
    rhoi_inv = physics.safe_inv(rho)
    pw_i = (rho - _f32(cfg.rho0)) * _f32(cfg.stiffness) * rhoi_inv * rhoi_inv
    mu_rhoi = _f32(cfg.viscosity) * rhoi_inv
    norm = cfg.visc_lap_norm
    acc = torch.stack([mu_rhoi * sums[3 + a] * norm
                       + (pw_i * sums[a] + sums[6 + a]) * norm
                       for a in range(3)], dim=-1)
    return acc, rho, count


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/sweep_t.cu``."""
    lib = build.load_library("sweep_t")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sph_density_band_t.argtypes = [p] * 10 + [i] * 8 + [f] * 4 + [p]
    lib.sph_density_band_t.restype = i
    lib.sph_force_band_t.argtypes = [p] * 9 + [i] * 7 + [f] * 8 + [p]
    lib.sph_force_band_t.restype = i
    lib.sph_fused_band_t.argtypes = [p] * 10 + [i] * 7 + [f] * 11 + [p]
    lib.sph_fused_band_t.restype = i
    lib.sph_band_rows_t.argtypes = [p] * 2 + [i] * 5 + [p] * 2
    lib.sph_band_rows_t.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _band_specs(cfg: SphConfig, n: int, m: int, pos_s, cid, cell_start,
                cand_src) -> dict:
    specs = dict(pos_s=(pos_s, torch.float32, (n, 3)),
                 cid=(cid, torch.int32, (n,)),
                 cell_start=(_table(cell_start), torch.int32,
                             (cfg.num_cells + 1,)))
    if cand_src is not None:
        specs["cand_src"] = (cand_src, torch.int32, (m,))
    return specs


def _launch_density_band(cfg: SphConfig, pos_s, mass_s, cid, cell_start,
                         cand_pos, cand_mass, cand_src=None,
                         self_base: int = 0, self_src=None, *, kernel: str):
    """K1 band walk of the self rows over candidates sorted by cell: the
    sorted particles over themselves (``cand_src`` None, exact), the live
    rows of a slab's extended frame (exact, self row i at ``self_base +
    i``), the capped sub frame (``cand_src`` its sorted rows) or, with
    ``self_src`` (the fused path's pre-pass), the sub frame over itself,
    self row i's own id ``self_src[i]``.  ``density_t_plain``'s
    arguments."""
    n, m, dev = pos_s.shape[0], cand_pos.shape[0], pos_s.device
    specs = _band_specs(cfg, n, m, pos_s, cid, cell_start, cand_src)
    if self_src is not None:
        specs["self_src"] = (self_src, torch.int32, (n,))
    _check(dev, mass_s=(mass_s, torch.float32, (n,)),
           cand_pos=(cand_pos, torch.float32, (m, 3)),
           cand_mass=(cand_mass, torch.float32, (m,)), **specs)
    excl = (EXCL_ROW if cand_src is None
            else EXCL_SRC if self_src is None else EXCL_SRC_SRC)
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    ncount = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernels()
    err = lib.sph_density_band_t(
        pos_s.data_ptr(), mass_s.data_ptr(), cid.data_ptr(), _ptr(self_src),
        cand_pos.data_ptr(), cand_mass.data_ptr(), _ptr(cand_src),
        cell_start.data_ptr(), rho.data_ptr(), ncount.data_ptr(), n, m,
        cfg.num_cells, cfg.grid_nx, cfg.grid_ny,
        int(cfg.include_self_density), excl, self_base, cfg.h2, cfg.h_scaled2,
        _f32(cfg.sim_scale * cfg.sim_scale), cfg.poly6_norm, _stream(dev))
    _raise_on(lib, err, kernel)
    return rho, ncount


def _launch_force_band(cfg: SphConfig, pos_s, vel_s, rho_s, cand, cid,
                       cell_start, cand_src=None, self_base: int = 0,
                       stats=None, *, kernel: str) -> torch.Tensor:
    """K2 band walk over candidates sorted by cell (``cand`` their
    ``fused_cand_cols``): the self rows (``cand_src`` None), a slab's live
    extended-frame rows (``self_base`` as for K1) or the sub frame; with
    ``stats``, its pairs and drain rounds added to that [2] int64 counter.
    ``force_t_plain``'s arguments."""
    n, m, dev = pos_s.shape[0], cand.shape[0], pos_s.device
    specs = _band_specs(cfg, n, m, pos_s, cid, cell_start, cand_src)
    if stats is not None:
        specs["stats"] = (stats, torch.int64, (2,))
    _check(dev, vel_s=(vel_s, torch.float32, (n, 3)),
           rho_s=(rho_s, torch.float32, (n,)),
           cand=(cand, torch.float32, (m, 9)), **specs)
    excl = EXCL_ROW if cand_src is None else EXCL_SRC
    acc = torch.empty(n, 3, dtype=torch.float32, device=dev)
    lib = _kernels()
    err = lib.sph_force_band_t(
        pos_s.data_ptr(), vel_s.data_ptr(), rho_s.data_ptr(), cid.data_ptr(),
        cand.data_ptr(), _ptr(cand_src), cell_start.data_ptr(),
        acc.data_ptr(), _ptr(stats), n, m, cfg.num_cells, cfg.grid_nx,
        cfg.grid_ny, excl, self_base, cfg.h2, cfg.h_scaled,
        _f32(cfg.sim_scale), _f32(cfg.pressure_softening),
        _f32(cfg.stiffness), _f32(cfg.rho0), _f32(cfg.viscosity),
        cfg.visc_lap_norm, _stream(dev))
    _raise_on(lib, err, kernel)
    return acc


def _launch_fused_band(cfg: SphConfig, pos_s, vel_s, mass_s, cid,
                       cell_start, cand, cand_src, self_base: int = 0, *,
                       kernel: str
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 band walk over the sub frame (``cand`` its ``fused_cand_cols``
    with the pre-pass densities, ``cand_src`` its src rows): capped K2's
    self rows, bands and exclusion (self row i's own id ``self_base +
    i``).  ``fused_t_plain``'s arguments."""
    n, m, dev = pos_s.shape[0], cand.shape[0], pos_s.device
    _check(dev, vel_s=(vel_s, torch.float32, (n, 3)),
           mass_s=(mass_s, torch.float32, (n,)),
           cand=(cand, torch.float32, (m, 9)),
           **_band_specs(cfg, n, m, pos_s, cid, cell_start, cand_src))
    acc = torch.empty(n, 3, dtype=torch.float32, device=dev)
    rho = torch.empty(n, dtype=torch.float32, device=dev)
    ncount = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _kernels()
    err = lib.sph_fused_band_t(
        pos_s.data_ptr(), vel_s.data_ptr(), mass_s.data_ptr(), cid.data_ptr(),
        cand.data_ptr(), cand_src.data_ptr(), cell_start.data_ptr(),
        acc.data_ptr(), rho.data_ptr(), ncount.data_ptr(), n, m,
        cfg.num_cells, cfg.grid_nx, cfg.grid_ny,
        int(cfg.include_self_density), self_base, cfg.h2, cfg.h_scaled2,
        _f32(cfg.sim_scale * cfg.sim_scale), cfg.poly6_norm, cfg.h_scaled,
        _f32(cfg.sim_scale), _f32(cfg.pressure_softening),
        _f32(cfg.stiffness), _f32(cfg.rho0), _f32(cfg.viscosity),
        cfg.visc_lap_norm, _stream(dev))
    _raise_on(lib, err, kernel)
    return acc, rho, ncount


def sweep(wrapper, twin, launch, kernel: str, cfg: SphConfig, *args, **kw):
    """``twin(cfg, *args, **kw)`` on CPU tensors, else ``launch(cfg, *args,
    **kw)`` of ``kernel``, counted in ``wrapper.launches``: one argument
    list, the device the only branch.  ``args[0]`` (the self positions)
    decides."""
    if _use_plain(args[0]):
        return twin(cfg, *args, **kw)
    out = launch(cfg, *args, kernel=kernel, **kw)
    wrapper.launches += 1
    return out


def density_t(cfg: SphConfig, pos_s: torch.Tensor, mass_s: torch.Tensor,
              cid: torch.Tensor, cell_start: torch.Tensor | None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact mode: (rho [N] f32, ncount [N] i32) of the sorted particles,
    their candidates the same sorted frame, over each row's cell bands
    (``cell_start``)."""
    return sweep(density_t, density_t_plain, _launch_density_band,
                 "density_band_t", cfg, pos_s, mass_s, cid, cell_start, pos_s,
                 mass_s)


def density_capped_t(cfg: SphConfig, pos_s: torch.Tensor,
                     mass_s: torch.Tensor, cid: torch.Tensor,
                     cell_start: torch.Tensor | None, cand_pos: torch.Tensor,
                     cand_mass: torch.Tensor, cand_src: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capped mode: (rho, ncount) of the sorted particles over the sub
    frame's candidates, each row's cell bands of the sub frame
    (``cell_start``); ``cand_src`` (the sub frame's sorted rows) excludes
    each particle itself."""
    return sweep(density_capped_t, density_t_plain, _launch_density_band,
                 "density_band_t<capped>", cfg, pos_s, mass_s, cid,
                 cell_start, cand_pos, cand_mass, cand_src)


def density_pre_t(cfg: SphConfig, pos_sub: torch.Tensor,
                  mass_sub: torch.Tensor, wm_sub: torch.Tensor,
                  cid_sub: torch.Tensor, src_sub: torch.Tensor,
                  cell_start: torch.Tensor | None) -> torch.Tensor:
    """Fused path's pre-pass: rho [S] of the sub-frame rows over the sub
    frame itself, each row's cell bands of the sub frame (``cell_start``;
    the tail rows' ``TAIL_CID`` reaches none).  Self rows carry the TRUE
    mass (the self term), the candidates the reweighted ``wm_sub``;
    exclusion compares src with src."""
    return sweep(density_pre_t, density_t_plain, _launch_density_band,
                 "density_band_t<prepass>", *_pre_args(
                     cfg, pos_sub, mass_sub, wm_sub, cid_sub, src_sub,
                     cell_start))[0]


def force_t(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
            rho_s: torch.Tensor, cand: torch.Tensor, cid: torch.Tensor,
            cell_start: torch.Tensor | None,
            stats: torch.Tensor | None = None) -> torch.Tensor:
    """Exact mode: hydro acceleration [N, 3] f32 of the sorted particles
    over their cell bands (``cell_start``); ``cand`` is ``fused_cand_cols``
    of the same sorted frame.  ``stats``: a [2] int64 counter the launch
    adds its pairs and drain rounds to (None: nothing counted)."""
    return sweep(force_t, force_t_plain, _launch_force_band, "force_band_t",
                 cfg, pos_s, vel_s, rho_s, cand, cid, cell_start,
                 stats=stats)


def force_capped_t(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
                   rho_s: torch.Tensor, cand: torch.Tensor, cid: torch.Tensor,
                   cell_start: torch.Tensor | None, cand_src: torch.Tensor,
                   stats: torch.Tensor | None = None) -> torch.Tensor:
    """Capped mode: hydro acceleration [N, 3] over the sub frame's
    candidates (``fused_cand_cols`` of the sub frame, reweighted masses),
    each row's cell bands of the sub frame (``cell_start``); ``stats`` as
    for ``force_t``."""
    return sweep(force_capped_t, force_t_plain, _launch_force_band,
                 "force_band_t<capped>", cfg, pos_s, vel_s, rho_s, cand, cid,
                 cell_start, cand_src, stats=stats)


def fused_t(cfg: SphConfig, pos_s: torch.Tensor, vel_s: torch.Tensor,
            mass_s: torch.Tensor, cid: torch.Tensor,
            cell_start: torch.Tensor | None, cand: torch.Tensor,
            cand_src: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused capped sweep: (acc [N, 3], rho [N], ncount [N]) in one pass
    over the sub frame's candidates, each row's cell bands of the sub frame
    (``cell_start``)."""
    return sweep(fused_t, fused_t_plain, _launch_fused_band, "fused_band_t",
                 cfg, pos_s, vel_s, mass_s, cid, cell_start, cand, cand_src)


def band_rows_t(cfg: SphConfig, cid: torch.Tensor, cell_start: torch.Tensor,
                m: int) -> torch.Tensor:
    """The lane-rows one band kernel launch tests over the bands of the
    self cids ``cid`` in the candidates' table ``cell_start`` of ``m``
    rows: per warp, 32 lanes times the sum over the 9 rods of the rows of
    the union of its lanes' bands (the walk ``csrc/band_walk.cuh``
    stages), summed over the warps; a 0-d int64 tensor on ``cid``'s
    device, read nowhere here.  The counter ``sweeps.rows_tested`` of
    ``utils/trace.py``."""
    if _use_plain(cid):
        return band_rows_t_plain(cfg, cid, cell_start, m)
    n, dev = cid.shape[0], cid.device
    _check(dev, cid=(cid, torch.int32, (n,)),
           cell_start=(cell_start, torch.int32, (cfg.num_cells + 1,)))
    rows = torch.zeros((), dtype=torch.int64, device=dev)
    lib = _kernels()
    err = lib.sph_band_rows_t(cid.data_ptr(), cell_start.data_ptr(), n, m,
                              cfg.num_cells, cfg.grid_nx, cfg.grid_ny,
                              rows.data_ptr(), _stream(dev))
    _raise_on(lib, err, "band_rows_t")
    band_rows_t.launches += 1
    return rows


@functools.cache
def _cand_kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/cand_cols_t.cu``."""
    lib = build.load_library("cand_cols_t")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sph_cand_cols_t.argtypes = ([p] * 6 + [ctypes.c_longlong] * 4
                                    + [i] * 2 + [f] * 2 + [p])
    lib.sph_cand_cols_t.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _cand_grid_cap(index: int) -> int:
    """Blocks of ``cand_cols_t``'s persistent grid on card ``index``."""
    return CAND_BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def _cand_checks(dev: torch.device, pos_c, vel_c, rho_c, m_c, index) -> int:
    """The candidate count M, once the inputs are what ``cand_cols_t``
    takes: float32 masses [M] and, over R rows (M without ``index``),
    positions and velocities [R, 3] whose last stride is 1 and densities
    [R], at any row stride; ``index`` a contiguous int32 [M]; all on
    ``dev``.  Raises ValueError otherwise."""
    def need(ok: bool, name: str, t: torch.Tensor, what: str) -> None:
        if not ok:
            raise ValueError(
                f"{name}: need {what} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} with strides {t.stride()} on {t.device}")

    need(m_c.dtype == torch.float32 and m_c.dim() == 1 and m_c.device == dev,
         "m_c", m_c, "a float32 [M] tensor")
    m = m_c.shape[0]
    rows = m
    if index is not None:
        _check(dev, index=(index, torch.int32, (m,)))
        rows = pos_c.shape[0] if pos_c.dim() == 2 else -1
    for name, t in (("pos_c", pos_c), ("vel_c", vel_c)):
        need(t.dtype == torch.float32 and tuple(t.shape) == (rows, 3)
             and t.device == dev and t.stride(1) == 1, name, t,
             f"a float32 [{rows}, 3] tensor whose last stride is 1")
    need(rho_c.dtype == torch.float32 and tuple(rho_c.shape) == (rows,)
         and rho_c.device == dev, "rho_c", rho_c,
         f"a float32 [{rows}] tensor")
    return m


def cand_blocks(m: int, cap: int) -> int:
    """Blocks of ``cand_cols_t``'s grid over ``m`` rows: one a tile of
    ``CAND_TILE`` rows up to ``cap``, each walking the tiles in a
    grid-stride loop."""
    return min(-(-m // CAND_TILE), cap)


def _launch_cand_cols(cfg: SphConfig, pos_c, vel_c, rho_c, m_c, index,
                      out) -> None:
    """Launch ``cand_cols_t`` over ``out``'s rows (at least one) on the
    current stream."""
    lib = _cand_kernels()
    m, dev = out.shape[0], out.device
    err = lib.sph_cand_cols_t(
        pos_c.data_ptr(), vel_c.data_ptr(), rho_c.data_ptr(), m_c.data_ptr(),
        _ptr(index), out.data_ptr(), pos_c.stride(0), vel_c.stride(0),
        rho_c.stride(0), m_c.stride(0), m,
        cand_blocks(m, _cand_grid_cap(dev.index or 0)), _f32(cfg.rho0),
        _f32(cfg.stiffness), _stream(dev))
    _raise_on(lib, err, "cand_cols_t")


def cand_cols_t(cfg: SphConfig, pos_c: torch.Tensor, vel_c: torch.Tensor,
                rho_c: torch.Tensor, m_c: torch.Tensor,
                index: torch.Tensor | None = None) -> torch.Tensor:
    """``fused_cand_cols`` on the card: one pass of the kernel
    ``cand_cols_t`` into a new [M, 9] tensor, the indexed instance where
    ``index`` is given, the arguments checked first; no rows launch
    nothing."""
    dev = m_c.device
    m = _cand_checks(dev, pos_c, vel_c, rho_c, m_c, index)
    out = torch.empty(m, 9, dtype=torch.float32, device=dev)
    if m:
        _launch_cand_cols(cfg, pos_c, vel_c, rho_c, m_c, index, out)
        cand_cols_t.launches += 1
    return out


def kept_rows_t(cfg: SphConfig, p: PreparedT) -> torch.Tensor:
    """The kept rows of a capped frame's bins, those within the sub frame
    (its cell starts' last entry) and those dropped past it: ``_sub_frame``'s
    kept count, as a 0-d int64 tensor on the frame's device.  The counter
    ``capped.kept_rows`` of ``utils/trace.py``."""
    return p.cell_start[cfg.num_cells].long() + p.sub_dropped


def capped_span(cfg: SphConfig, name: str, dev: torch.device):
    """``trace.span(name, dev)`` in capped mode; in exact mode no span, so
    its ``binning.prepare`` and ``sweeps.sorted`` stay leaves."""
    return trace.span(name, dev) if cfg.capped_candidates else _NO_SPAN


def band_rows_t_plain(cfg: SphConfig, cid: torch.Tensor,
                      cell_start: torch.Tensor, m: int) -> torch.Tensor:
    """``band_rows_t``'s twin: 32 times ``walk_stats.band_sums``' warp
    union of the same bands."""
    return walk_stats.WARP * walk_stats.band_sums(
        *band_ranges(cfg, cid, cell_start), m)["warp_union"]


WRAPPERS = (density_t, density_capped_t, density_pre_t, force_t,
            force_capped_t, fused_t, band_rows_t, cand_cols_t)
for _w in WRAPPERS:
    _w.launches = 0


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------

def gather_sub_pv(p: PreparedT) -> tuple[torch.Tensor, torch.Tensor]:
    """(positions [S, 3], velocities [S, 3]) of the capped sub frame,
    gathered fresh each step (positions drift between rebins) and shared by
    the step's sweeps."""
    return p.pos_s[p.sub_perm], p.vel_s[p.sub_perm]


def density_sweep_t(cfg: SphConfig, p: PreparedT
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho_s, ncount_s) in sorted order; capped, over the sub frame's
    positions, gathered here (K2 gathers its own rows)."""
    trace.count(ROWS_TESTED, p.rows_tested)
    if not cfg.capped_candidates:
        return density_t(cfg, p.pos_s, p.mass_s, p.cid, p.cell_start)
    dev = p.pos_s.device
    with trace.span("sweeps.capped_gather", dev):
        pos_sub = p.pos_s[p.sub_perm]
    with trace.span("sweeps.walks", dev):
        return density_capped_t(cfg, p.pos_s, p.mass_s, p.cid, p.cell_start,
                                pos_sub, p.wm_sub, p.sub_perm)


def force_sweep_t(cfg: SphConfig, p: PreparedT, rho_s: torch.Tensor
                  ) -> torch.Tensor:
    """acc_s [N, 3] in sorted order (hydro only; gravity/CFL by the caller).
    Capped: the candidates are the sorted rows ``sub_perm`` names, their
    positions, velocities and densities gathered by ``fused_cand_cols``
    itself, their masses the reweighted ``wm_sub``.  While recording, K2
    adds its pairs and drain rounds to the bins' ``force_stats``."""
    trace.count(ROWS_TESTED, p.rows_tested)
    stats = p.force_stats if trace.recording() else None
    if not cfg.capped_candidates:
        cand = fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_s, p.mass_s)
        return force_t(cfg, p.pos_s, p.vel_s, rho_s, cand, p.cid,
                       p.cell_start, stats)
    dev = p.pos_s.device
    with trace.span("sweeps.capped_gather", dev):
        cand = fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_s, p.wm_sub,
                               index=p.sub_perm)
    with trace.span("sweeps.walks", dev):
        return force_capped_t(cfg, p.pos_s, p.vel_s, rho_s, cand, p.cid,
                              p.cell_start, p.sub_perm, stats)


def density_sub_t(cfg: SphConfig, p: PreparedT, pv_sub) -> torch.Tensor:
    """Fused-path pre-pass: capped density [S] of the sub-frame rows only
    (the candidates' pressures are its only consumer).  Tail rows
    [n_kept, S) get values no pair ever reads: no band reaches them."""
    dev = p.pos_s.device
    with trace.span("sweeps.capped_gather", dev):
        mass_sub = p.mass_s[p.sub_perm]
    with trace.span("sweeps.walks", dev):
        return density_pre_t(cfg, pv_sub[0], mass_sub, p.wm_sub, p.cand_cid,
                             p.sub_perm, p.cell_start)


def fused_sweep_t(cfg: SphConfig, p: PreparedT, rho_sub: torch.Tensor,
                  pv_sub) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused pass: (acc_s hydro-only, rho_s, ncount_s) for all N, the
    candidates' pressures from the pre-pass densities ``rho_sub``."""
    trace.count(ROWS_TESTED, p.rows_tested)
    dev = p.pos_s.device
    with trace.span("sweeps.capped_gather", dev):
        cand = fused_cand_cols(cfg, pv_sub[0], pv_sub[1], rho_sub, p.wm_sub)
    with trace.span("sweeps.walks", dev):
        return fused_t(cfg, p.pos_s, p.vel_s, p.mass_s, p.cid, p.cell_start,
                       cand, p.sub_perm)


def sweeps_sorted(cfg: SphConfig, p: PreparedT
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sweeps + gravity + CFL clamp, all in the sorted frame, in the
    span ``sweeps.sorted`` (``utils/trace.py``).  Capped mode with
    ``capped_fused`` runs the pre-pass and the fused pass instead of the two
    full sweeps.

    In capped mode the span's children tile it: ``sweeps.capped_gather``
    (the sub frame's positions gathered for K1, and velocities too for the
    fused path; the candidate columns built),
    ``sweeps.walks`` (each band walk) and ``sweeps.body`` (gravity and the
    CFL clamp); and the step counts ``capped.kept_rows`` once.  In exact
    mode ``sweeps.sorted`` has no children."""
    dev = p.pos_s.device
    with trace.span("sweeps.sorted", dev):
        if cfg.capped_candidates:
            trace.count(KEPT_ROWS, p.kept_rows)
        if cfg.capped_candidates and cfg.capped_fused:
            with trace.span("sweeps.capped_gather", dev):
                pv_sub = gather_sub_pv(p)
            rho_sub = density_sub_t(cfg, p, pv_sub)
            acc_s, rho_s, ncount_s = fused_sweep_t(cfg, p, rho_sub, pv_sub)
        else:
            rho_s, ncount_s = density_sweep_t(cfg, p)
            acc_s = force_sweep_t(cfg, p, rho_s)
        with capped_span(cfg, "sweeps.body", dev):
            acc_s = acc_s + physics.central_gravity(cfg, p.pos_s)
            acc_s = acc_s + torch.tensor(cfg.gravity, dtype=torch.float32,
                                         device=acc_s.device)
            return physics.cfl_clamp(cfg, acc_s), rho_s, ncount_s


def truncated_ranges(p: PreparedT) -> torch.Tensor:
    """The step's counted candidate loss: capped kept rows beyond the sub
    frame (0 in exact mode, whose bands are walked in full)."""
    if p.sub_dropped is not None:
        return p.sub_dropped
    return torch.zeros((), dtype=torch.int32, device=p.pos_s.device)


def compute_step_quantities(cfg: SphConfig, state: ParticleState
                            ) -> tuple[torch.Tensor, torch.Tensor, CellListAux]:
    """(acc, rho, aux) in the caller's particle order, the cell-list
    backend's contract.  This layout has no per-cell capacity, so
    ``aux.overflow_cells`` is 0, as in the JAX package; its only counted
    loss is the capped sub frame's overflow."""
    p = prepare_t(cfg, state)
    acc_s, rho_s, ncount_s = sweeps_sorted(cfg, p)
    acc, rho, ncount = unsort_stacked(inverse_order(p.order),
                                      [acc_s, rho_s, ncount_s])
    zero = torch.zeros((), dtype=torch.int32, device=acc.device)
    return acc, rho, CellListAux(neighbor_count=ncount, overflow_cells=zero,
                                 truncated_ranges=truncated_ranges(p))
