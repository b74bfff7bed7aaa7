"""Distributed SPH step over fixed z slabs: local sort, halo exchange and
migration between ranks, per-rank memory O(N/D + capacities).

Counterpart of ``smoothed_particle_hydrodynamics_tpu/parallel/slabs.py``,
whose module docstring sets out the design.  In short: rank d owns the
particles inside its band of z cell-planes ``zsplit[d]:zsplit[d + 1]``,
bins and sorts only those, receives ``h_cap`` sorted rows from each ring
neighbour every step (its extended frame [left halo | own slab | right
halo]) and, at rebins, hands particles that left its band to the
neighbour toward their slab, one rank per hop, until every mover has
landed.  Capacity misses are counted in the diagnostics
(``halo_dropped``, ``migration_dropped``, ``truncated_ranges``), never
silent.

Where the JAX engine is one ``shard_map`` program, here each rank is one
process running ``slab_step_body`` on its own ``[p_cap, 8]`` store, with
the collectives of a ``comm.SlabGroup``: ``lax.ppermute`` becomes a ring
send/recv, ``psum``/``pmax`` an ``all_reduce``, and ``lax.cond`` /
``while_loop`` become Python branches and loops on a value every rank reads
after one ``all_reduce`` (the rebin decision, the hop loop's pending count),
so every rank issues the same collectives in the same order.  Capacities,
split and the frozen rebin state live on the host as Python ints; tensors
stay on the rank's device.

Store layout (as the JAX package): rows of (pos xyz, vel xyz, mass,
orig_id) in f32; invalid rows carry orig_id -1, position 1e30 and mass 0,
so they fall out of every pair mask and tally.  Cell ids are int32 (the
JAX package codes them as f32 inside its kernels), and the capped sub
frame's unkept tail carries ``sweeps_t.TAIL_CID`` instead of -10.

The sweeps are ``celllist`` (plain PyTorch cell-list ranges, no kernel) or
``pallas``: the CUDA kernels of ``csrc/sweep_t.cu`` over the extended frame
(``slab_sweeps``), exact (band walks over the frame's live rows) or, with
``cfg.capped_candidates``, capped (two-pass, band walks over the sub frame,
or, with ``cfg.capped_fused``, pre-pass + fused).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SphConfig, _f32
from ..ops import celllist
from ..ops import sweeps_t as sw
from ..ops.grid import NO_CELL, cell_coords, linear_cell_id
from ..ops.integrate import kdk_integrate
from ..ops.lazy import skin_half
from ..state import (ParticleState, StepDiagnostics, diagnostics_rows,
                     state_from_numpy, state_to_numpy)
from . import slab_sweeps as ss
from .comm import SlabGroup

_BIG = _f32(1e30)

# store column layout
_POS = slice(0, 3)
_VEL = slice(3, 6)
_MASS = 6
_OID = 7
_NCOLS = 8


class SlabCarry(NamedTuple):
    """One rank's slab store."""

    fields: torch.Tensor      # [p_cap, 8] f32
    count: int                # valid rows


def _nzs(cfg: SphConfig, ndev: int) -> int:
    if cfg.grid_nz % ndev:
        raise ValueError(f"grid_nz={cfg.grid_nz} must divide by {ndev} devices")
    nzs = cfg.grid_nz // ndev
    if nzs < 2:
        raise ValueError("need >= 2 z cell-planes per device")
    return nzs


def _zplane(cfg: SphConfig, z: torch.Tensor) -> torch.Tensor:
    """z coordinate -> clamped z cell-plane index (int32)."""
    zp = torch.floor(z * _f32(cfg.inv_cell_size)).to(torch.int32)
    return zp.clamp(0, cfg.grid_nz - 1)


def _plane_histogram(cfg: SphConfig, state: ParticleState) -> np.ndarray:
    zp = _zplane(cfg, state.position[:, 2]).cpu().numpy()
    return np.bincount(zp, minlength=cfg.grid_nz).astype(np.int64)


def uniform_zsplit(cfg: SphConfig, ndev: int) -> tuple[int, ...]:
    """Equal-volume partition: ndev equal runs of z cell-planes."""
    nzs = _nzs(cfg, ndev)
    return tuple(range(0, cfg.grid_nz + 1, nzs))


def derive_zsplit(cfg: SphConfig, state: ParticleState,
                  ndev: int) -> tuple[int, ...]:
    """Occupancy-weighted partition: contiguous plane runs of near-equal
    particle count, each >= 2 planes (host-side)."""
    _nzs(cfg, ndev)
    nz = cfg.grid_nz
    cum = np.cumsum(_plane_histogram(cfg, state))
    total = int(cum[-1])
    splits = [0]
    for k in range(1, ndev):
        z = int(np.searchsorted(cum, total * k / ndev)) + 1
        z = max(splits[-1] + 2, min(z, nz - 2 * (ndev - k)))
        splits.append(z)
    splits.append(nz)
    return tuple(splits)


def derive_slab_caps(cfg: SphConfig, state: ParticleState, ndev: int,
                     headroom: float = 1.5,
                     zsplit: tuple[int, ...] | None = None
                     ) -> tuple[int, int, int]:
    """(p_cap, h_cap, m_cap) from the state's plane occupancy, rounded up
    to the sweep block width (host-side)."""
    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    plane = _plane_histogram(cfg, state)
    slab = np.asarray([plane[zsplit[d]:zsplit[d + 1]].sum()
                       for d in range(ndev)])
    p_cap = int(max(slab.max(), 1) * headroom) + 64
    h_cap = int(max(plane.max(), 1) * headroom) + 64
    # one full plane of migration capacity per direction per hop
    m_cap = max(h_cap, 64)
    b = sw._blane(cfg)
    rnd = lambda v: -(-v // b) * b
    return rnd(p_cap), rnd(h_cap), rnd(m_cap)


def partition(cfg: SphConfig, state: ParticleState, ndev: int, p_cap: int,
              zsplit: tuple[int, ...] | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: every rank's store, ``([ndev * p_cap, 8] f32 rows,
    [ndev] i32 counts)``, rank d's rows at ``[d * p_cap, (d + 1) * p_cap)``
    (the JAX package's ``distribute`` before its device_put)."""
    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    zp = _zplane(cfg, state.position[:, 2]).cpu().numpy()
    dest = np.clip(np.searchsorted(zsplit, zp, side="right") - 1, 0, ndev - 1)
    fields = np.zeros((ndev * p_cap, _NCOLS), np.float32)
    fields[:, 0:3] = _BIG
    fields[:, _OID] = -1.0
    count = np.zeros((ndev,), np.int32)
    pos = state.position.cpu().numpy()
    vel = state.velocity.cpu().numpy()
    mass = state.mass.cpu().numpy()
    for d in range(ndev):
        rows = np.nonzero(dest == d)[0]
        if len(rows) > p_cap:
            raise ValueError(f"slab {d} population {len(rows)} > p_cap {p_cap}")
        base = d * p_cap
        k = len(rows)
        fields[base:base + k, 0:3] = pos[rows]
        fields[base:base + k, 3:6] = vel[rows]
        fields[base:base + k, _MASS] = mass[rows]
        fields[base:base + k, _OID] = rows.astype(np.float32)
        count[d] = k
    return fields, count


def distribute(cfg: SphConfig, state: ParticleState, group: SlabGroup,
               p_cap: int, zsplit: tuple[int, ...] | None = None) -> SlabCarry:
    """This rank's slab store on its device (every rank partitions the same
    host state)."""
    fields, count = partition(cfg, state, group.world, p_cap, zsplit)
    r = group.rank
    return SlabCarry(
        fields=torch.from_numpy(fields[r * p_cap:(r + 1) * p_cap].copy())
        .to(group.device), count=int(count[r]))


def collect_rows(fields: np.ndarray, n: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: (position, velocity, mass) in original order from store
    rows of any number of ranks (invalid rows skipped)."""
    oid = fields[:, _OID].astype(np.int64)
    valid = oid >= 0
    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)
    mass = np.zeros((n,), np.float32)
    pos[oid[valid]] = fields[valid][:, 0:3]
    vel[oid[valid]] = fields[valid][:, 3:6]
    mass[oid[valid]] = fields[valid][:, _MASS]
    return pos, vel, mass


def collect(group: SlabGroup, carry, n: int) -> ParticleState:
    """Gather every rank's store (a collective) into a ParticleState in the
    original particle order, on this rank's device."""
    rows = group.all_gather(carry.fields).reshape(-1, _NCOLS)
    pos, vel, mass = collect_rows(rows.cpu().numpy(), n)
    return ParticleState.from_arrays(
        torch.from_numpy(pos).to(group.device),
        torch.from_numpy(vel).to(group.device),
        mass=torch.from_numpy(mass).to(group.device))


def _sort_local(cfg: SphConfig, fields: torch.Tensor, slab_hi: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort a rank's rows by global linear cell id, stably.  Invalid rows
    get cid ``slab_hi - 1`` (the slab's last own cell), which keeps them
    after every valid row and the extended frame globally ascending."""
    valid = fields[:, _OID] >= 0.0
    cid = linear_cell_id(cfg, cell_coords(cfg, fields[:, 0:3]))
    cid = torch.where(valid, cid, slab_hi - 1)
    cid_sorted, perm = torch.sort(cid, stable=True)
    return fields[perm], cid_sorted


def _edge_window(fields_s: torch.Tensor, cid_s: torch.Tensor, cnt: int,
                 h_cap: int, tail: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``h_cap`` sorted rows nearest one slab edge, sent raw (see the
    JAX package's ``_edge_window`` for why rows past the edge plane keep
    their true cids)."""
    start = max(cnt - h_cap, 0) if tail else 0
    return fields_s[start:start + h_cap], cid_s[start:start + h_cap]


def _local_ranges(cfg: SphConfig, cid_ext: torch.Tensor,
                  cid_rows: torch.Tensor, row_valid: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """[rows, 9] contiguous candidate ranges into the extended frame, found
    by binary search on each stencil rod's bounds (the frame's cids are
    globally ascending)."""
    nx, ny, nz = cfg.grid_nx, cfg.grid_ny, cfg.grid_nz
    x = cid_rows % nx
    y = (cid_rows // nx) % ny
    z = cid_rows // (nx * ny)
    starts, ends = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            ok = (row_valid & (y + dy >= 0) & (y + dy < ny)
                  & (z + dz >= 0) & (z + dz < nz))
            base = cid_rows + (dz * ny + dy) * nx
            lo = base - (x > 0).to(torch.int32)
            hi = base + (x < nx - 1).to(torch.int32)
            s = torch.searchsorted(cid_ext, lo, side="left", out_int32=True)
            e = torch.searchsorted(cid_ext, hi + 1, side="left",
                                   out_int32=True)
            starts.append(torch.where(ok, s, 0))
            ends.append(torch.where(ok, e, 0))
    return torch.stack(starts, dim=1), torch.stack(ends, dim=1)


def _band_tables(cfg: SphConfig, ext: torch.Tensor, cid_ext: torch.Tensor,
                 cid_s: torch.Tensor, cnt: int, h_cap: int
                 ) -> ss.SlabBand:
    """The exact band kernels' frozen tables (rebins only): the extended
    frame's live rows in order (valid halo rows and the own slab's first
    ``cnt``), the search of their cids for each cell's first row, and the
    own cids with ``NO_CELL`` on the dead rows.

    The frame's cids ascend, so its live rows' do too.  The inert chain
    ends, the own dead run (cid ``slab_hi - 1``) and a short neighbour's
    dead rows (its last cell) are left out: a table over the raw frame
    would put the dead runs inside real cells' row ranges.
    """
    rows = torch.nonzero(ext[:, _OID] >= 0.0).squeeze(1)
    nl = int((rows < h_cap).sum())
    return ss.SlabBand(_cell_start(cfg, cid_ext[rows]), _own_cids(cid_s, cnt),
                       rows, nl, rows.shape[0] - nl - cnt)


def _cell_start(cfg: SphConfig, cid_sorted: torch.Tensor) -> torch.Tensor:
    """[num_cells + 1] i32: the first row of each cell in ascending cids
    (a row at ``num_cells`` or above lies past every cell)."""
    return torch.searchsorted(
        cid_sorted, torch.arange(cfg.num_cells + 1, dtype=torch.int32,
                                 device=cid_sorted.device), out_int32=True)


def _own_cids(cid_s: torch.Tensor, cnt: int) -> torch.Tensor:
    """The band kernels' self cids: the own slab's, ``NO_CELL`` on the dead
    rows ``[cnt, p_cap)`` (which sit in the slab's last cell at 1e30): they
    walk no band and write rho 0, count 0, acc 0."""
    own = torch.arange(cid_s.shape[0], device=cid_s.device)
    return torch.where(own < cnt, cid_s, NO_CELL).to(torch.int32)


def _sub_band(cfg: SphConfig, cid_search: torch.Tensor, cid_s: torch.Tensor,
              cnt: int) -> ss.SubBand:
    """The capped band kernels' frozen table (rebins only): the search of
    the sub frame's cids (its kept rows lead in cid order, the unkept tail
    sits at ``num_cells``, so ``cell_start[num_cells]`` is the kept count
    and no band reaches the tail) and the own cids with ``NO_CELL`` on the
    dead rows."""
    return ss.SubBand(_cell_start(cfg, cid_search), _own_cids(cid_s, cnt))


def _capped_sub_frame(cfg: SphConfig, ext: torch.Tensor,
                      cid_ext: torch.Tensor, sub_len: int, slab_lo: int,
                      slab_hi: int):
    """Kept-candidate sub frame over the extended frame (capped mode).

    The single-chip policy, K_c lowest ``hash(oid)`` per cell, on the
    global original id, so neighbouring ranks keep the same set of a
    shared halo cell; only the cells this rank can query (own slab +- one
    plane) contribute.  The JAX package's sorts become one stable int64
    sort: (cid << hb | top hash bits, oid) when ``hb >= 8``, else (cid,
    full hash), ties in the extended-frame row.  Invalid rows (dead, or in
    no queryable cell) sort after every valid row into a run of their own
    at ``num_cells``.  This diverges from the JAX package, whose sentinel
    key ``0x7FFFFFFF >> hb`` is the last cell's id on a power-of-two grid:
    there the last cell's run absorbs the invalid rows (and a valid row
    whose top hash bits are all ones is taken as invalid), inflating its
    kept rows' ``occ / min(occ, K_c)`` weights.

    Returns (sub_src [S] i32 extended-frame row of each sub row, cand_cid
    [S] i32 (``TAIL_CID`` past the kept rows), cid_search [S] i32
    (``num_cells`` past them), w_sub [S] f32 mass weights, sub_dropped
    0-d i32 kept rows beyond S).
    """
    dev = ext.device
    e = ext.shape[0]
    oid = ext[:, _OID].to(torch.int32)
    nxny = cfg.grid_nx * cfg.grid_ny
    queryable = (cid_ext >= slab_lo - nxny) & (cid_ext < slab_hi + nxny)
    valid = (oid >= 0) & queryable
    pos = torch.arange(e, dtype=torch.int32, device=dev)
    hb = sw._hash_bits(cfg)
    cid_c = cid_ext.long().clamp(0, cfg.num_cells - 1)
    if hb >= 8:
        # a valid key reaches 0x7FFFFFFF (the last cell of a power-of-two
        # grid, all hash bits set), so invalid rows sort past it at 2^31;
        # (key, oid): oid + 1 in [0, 2^31) fits the low 31 bits
        key = torch.where(valid, (cid_c << hb) | (sw._hash32(oid) >> (31 - hb)),
                          1 << 31)
        order = torch.sort((key << 31) | (oid.long() + 1), stable=True).indices
        key_s = key[order] >> hb      # cid runs
    else:
        key = torch.where(valid, cid_c, cfg.num_cells)
        order = torch.sort((key << 32) | sw._hash32(oid), stable=True).indices
        key_s = key[order]
    # invalid rows (sorted last) form one run of their own at num_cells, so
    # they never join the last cell's run and its occupancy
    invalid_s = ~valid[order]
    key_s = torch.where(invalid_s, cfg.num_cells, key_s)
    pos_s = pos[order]
    rank, occ = sw._run_rank_occ(key_s)
    k_c = cfg.capped_candidates
    keep_s = (rank < k_c) & ~invalid_s
    if cfg.capped_reweight:
        w_s = occ.to(torch.float32) / occ.clamp(max=k_c).to(torch.float32)
    else:
        w_s = torch.ones(e, dtype=torch.float32, device=dev)
    take = torch.sort((~keep_s).to(torch.int32), stable=True).indices[:sub_len]
    sub_src = pos_s[take]
    n_kept_all = keep_s.sum()
    sub_dropped = (n_kept_all - sub_len).clamp(min=0).to(torch.int32)
    in_kept = torch.arange(sub_len, device=dev) < n_kept_all
    cid_sub = key_s[take].to(torch.int32)
    cand_cid = torch.where(in_kept, cid_sub, sw.TAIL_CID)
    cid_search = torch.where(in_kept, cid_sub, cfg.num_cells)
    w_sub = torch.where(in_kept, w_s[take], 0.0)
    return sub_src, cand_cid, cid_search, w_sub, sub_dropped


class LazySlabCarry(NamedTuple):
    """One rank's slab store + frozen binning structure (lazy rebinning).

    Between rebins the row order of ``fields`` is frozen (sorted by
    bin-time cell id); only the values evolve.  ``pos_bin``, ``cid`` and
    ``tabs`` are the frozen structure, rebuilt when the global per-axis
    displacement spread exceeds cell - h (the single-chip lazy driver's
    invariant).  ``tabs`` is (rng_s, rng_e) for the celllist sweeps, (band,)
    for the exact kernels (the band walks' ``slab_sweeps.SlabBand``), and
    (sub_src, cand_cid, w_sub, sub_dropped, sub_band) in capped mode, two-pass
    and fused (``sub_band`` the band walks' ``slab_sweeps.SubBand``).
    """

    fields: torch.Tensor   # [p_cap, 8] f32, bin-time sorted order
    count: int             # valid rows
    pos_bin: torch.Tensor  # [p_cap, 3] positions at bin time
    cid: torch.Tensor      # [p_cap] i32 frozen sorted cell ids
    tabs: tuple            # frozen sweep tables (see docstring)
    steps_since: int       # -1 = initial build pending
    rebin_count: int       # rebins so far (the initial build included)


def _inert(rows: int, device) -> torch.Tensor:
    t = torch.zeros(rows, _NCOLS, dtype=torch.float32, device=device)
    t[:, 0:3] = _BIG
    t[:, _OID] = -1.0
    return t


def _migrate(cfg: SphConfig, group: SlabGroup, fields: torch.Tensor,
             zsplit: tuple[int, ...], p_cap: int, m_cap: int
             ) -> tuple[torch.Tensor, int, int]:
    """Route every valid row whose z plane left this rank's band toward its
    slab, one rank per hop, until the group's pending count (one psum per
    hop, read by every rank) is 0.  Returns (store, overflow, dropped):
    rows past ``p_cap`` and movers past ``m_cap`` per direction and hop are
    lost and counted."""
    dev = group.device
    d, ndev = group.rank, group.world
    zs = torch.tensor(zsplit, dtype=torch.int32, device=dev)
    inert_m = _inert(m_cap, dev)

    def dest_of(f):
        zp = _zplane(cfg, f[:, 2])
        return (torch.searchsorted(zs, zp, right=True, out_int32=True)
                - 1).clamp(0, ndev - 1)

    def pending(f) -> int:
        moving = (f[:, _OID] >= 0.0) & (dest_of(f) != d)
        return int(group.psum(moving.sum().reshape(1)))

    def hop(f):
        valid_f = f[:, _OID] >= 0.0
        dest = dest_of(f)
        go_left = valid_f & (dest < d)
        go_right = valid_f & (dest > d)
        stay = valid_f & (dest == d)
        # stayers | left | right | inert, each in storage order
        key = torch.where(stay, 0, torch.where(
            go_left, 1, torch.where(go_right, 2, 3)))
        packed = f[torch.sort(key, stable=True).indices]
        n_stay, n_left, n_right = torch.stack(
            [stay.sum(), go_left.sum(), go_right.sum()]).tolist()

        def take(start, n_take):
            rows = inert_m.clone()
            rows[:n_take] = packed[start:start + n_take]
            return rows

        in_r = group.shift_down(take(n_stay, min(n_left, m_cap)))
        in_l = group.shift_up(take(n_stay + n_left, min(n_right, m_cap)))
        if d == ndev - 1:
            in_r = inert_m
        if d == 0:
            in_l = inert_m
        n_in_l, n_in_r = torch.stack([(in_l[:, _OID] >= 0.0).sum(),
                                      (in_r[:, _OID] >= 0.0).sum()]).tolist()
        buf = _inert(p_cap + 2 * m_cap, dev)
        buf[:n_stay] = packed[:n_stay]
        buf[n_stay:n_stay + m_cap] = in_l
        buf[n_stay + n_in_l:n_stay + n_in_l + m_cap] = in_r
        return (buf[:p_cap], max(n_stay + n_in_l + n_in_r - p_cap, 0),
                max(n_left - m_cap, 0) + max(n_right - m_cap, 0))

    overflow = dropped = 0
    while pending(fields) > 0:
        fields, ov, dr = hop(fields)
        overflow += ov
        dropped += dr
    return fields, overflow, dropped


class SlabFrame(NamedTuple):
    """A rank's step inputs once the rebin decision, migration, halo
    exchange and (at rebins) the tables are done."""

    fields_s: torch.Tensor   # [p_cap, 8] own slab in (frozen) sorted order
    cid_s: torch.Tensor      # [p_cap] i32 its cell ids
    count: int               # valid rows
    pos_bin: torch.Tensor    # [p_cap, 3] positions at bin time
    ext: torch.Tensor        # [h_cap + p_cap + h_cap, 8] extended frame
    cid_ext: torch.Tensor    # its cell ids (-1 / num_cells at chain ends)
    tabs: tuple              # sweep tables (LazySlabCarry.tabs)
    need: bool               # this step rebinned
    lost: int                # migration drops + slab overflow


def prepare_frame(cfg: SphConfig, group: SlabGroup, p_cap: int, h_cap: int,
                  m_cap: int, sweeps: str, zsplit: tuple[int, ...],
                  lazy: bool, sub_len: int, carry: LazySlabCarry
                  ) -> SlabFrame:
    """The first half of a step: decide the rebin (one pmax, read by every
    rank), migrate and re-sort at rebins, exchange the edge windows, and
    build the sweep tables at rebins."""
    dev = group.device
    d, ndev = group.rank, group.world
    nxny = cfg.grid_nx * cfg.grid_ny
    fields, cnt = carry.fields, carry.count
    slab_lo, slab_hi = zsplit[d] * nxny, zsplit[d + 1] * nxny

    # ---- rebin decision: one pmax of the per-axis extrema ------------------
    # the SPREAD of displacements expires frozen bins (common-mode
    # translation never does)
    if lazy:
        valid0 = (fields[:, _OID] >= 0.0)[:, None]
        delta = fields[:, 0:3] - carry.pos_bin
        neg = torch.full_like(delta, -_BIG)
        ext_v = group.pmax(torch.cat([
            torch.where(valid0, delta, neg).amax(0),
            torch.where(valid0, -delta, neg).amax(0),
            torch.tensor([float(carry.steps_since < 0)], device=dev)]))
        spread = (ext_v[0:3] + ext_v[3:6]).max()
        need = bool((ext_v[6] > 0) | (spread > _f32(2.0 * skin_half(cfg))))
    else:
        need = True

    # ---- migration + local re-sort (rebins only) ---------------------------
    if need:
        buf, overflow, dropped = _migrate(cfg, group, fields, zsplit, p_cap,
                                          m_cap)
        cnt = int((buf[:, _OID] >= 0.0).sum())
        fields_s, cid_s = _sort_local(cfg, buf, slab_hi)
        pos_bin, lost = fields_s[:, 0:3], overflow + dropped
    else:
        fields_s, cid_s, pos_bin, lost = fields, carry.cid, carry.pos_bin, 0

    # ---- halo exchange (every step: values move, structure is frozen) -----
    # rows and cids ride one message, the cids' bits as an f32 column
    def halo_msg(rows, cids):
        return torch.cat([rows, cids.view(torch.float32)[:, None]], dim=1)

    from_left = group.shift_up(halo_msg(*_edge_window(
        fields_s, cid_s, cnt, h_cap, tail=True)))
    from_right = group.shift_down(halo_msg(*_edge_window(
        fields_s, cid_s, cnt, h_cap, tail=False)))
    # chain ends: inert rows with cids outside every queryable cell
    if d == 0:
        rows_l = _inert(h_cap, dev)
        cid_l = torch.full((h_cap,), -1, dtype=torch.int32, device=dev)
    else:
        rows_l = from_left[:, :_NCOLS]
        cid_l = from_left[:, _NCOLS].contiguous().view(torch.int32)
    if d == ndev - 1:
        rows_r = _inert(h_cap, dev)
        cid_r = torch.full((h_cap,), cfg.num_cells, dtype=torch.int32,
                           device=dev)
    else:
        rows_r = from_right[:, :_NCOLS]
        cid_r = from_right[:, _NCOLS].contiguous().view(torch.int32)
    ext = torch.cat([rows_l, fields_s, rows_r])
    cid_ext = torch.cat([cid_l, cid_s, cid_r])

    # ---- frozen tables (rebins only) ---------------------------------------
    capped = bool(cfg.capped_candidates) and sweeps == "pallas"
    if not need:
        tabs = carry.tabs
    elif capped:
        sub_src, cand_cid, cid_search, w_sub, sub_dropped = _capped_sub_frame(
            cfg, ext, cid_ext, sub_len, slab_lo, slab_hi)
        tabs = (sub_src, cand_cid, w_sub, sub_dropped,
                _sub_band(cfg, cid_search, cid_s, cnt))
    elif sweeps == "pallas":
        tabs = (_band_tables(cfg, ext, cid_ext, cid_s, cnt, h_cap),)
    else:
        tabs = _local_ranges(cfg, cid_ext, cid_s, fields_s[:, _OID] >= 0.0)
    return SlabFrame(fields_s, cid_s, cnt, pos_bin, ext, cid_ext, tabs, need,
                     lost)


def exchange_rho(group: SlabGroup, rho_l: torch.Tensor, count: int,
                 h_cap: int) -> torch.Tensor:
    """The extended frame's densities: the neighbours' edge-window rows
    around ``rho_l`` (0 at the chain ends)."""
    start = max(count - h_cap, 0)
    rho_left = group.shift_up(rho_l[start:start + h_cap])
    rho_right = group.shift_down(rho_l[:h_cap])
    if group.rank == 0:
        rho_left = torch.zeros_like(rho_left)
    if group.rank == group.world - 1:
        rho_right = torch.zeros_like(rho_right)
    return torch.cat([rho_left, rho_l, rho_right])


def scatter_sub_rho(rho_sub: torch.Tensor, sub_src: torch.Tensor,
                    cand_cid: torch.Tensor, h_cap: int, p_cap: int
                    ) -> torch.Tensor:
    """Fused path: the kept own-slab sub rows' pre-pass densities in the
    own slab's row layout, so ``exchange_rho`` ships them with the same
    edge windows as the fields.  Rows this rank did not keep get -1 (the
    JAX engine writes 0 there): see ``fused_candidates``."""
    local_idx = sub_src.long() - h_cap
    is_local = (cand_cid >= 0) & (local_idx >= 0) & (local_idx < p_cap)
    rho_l = torch.full((p_cap + 1,), -1.0, dtype=torch.float32,
                       device=rho_sub.device)
    rho_l[torch.where(is_local, local_idx, p_cap)] = rho_sub
    return rho_l[:p_cap]


def fused_candidates(rho_e: torch.Tensor, sub_src: torch.Tensor,
                     w_sub: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho_cand, w_sub) of the fused pass's candidates: each sub row's
    pre-pass density from its owner.  A candidate its owner did not keep
    (the owner's sub frame overflowed, or a truncated halo showed this rank
    part of a cell; both counted) has no such density: it enters with zero
    mass.  The JAX engine reads rho 0 for it, whose pressure -rho0 k blows
    the run up (``ROADMAP.md`` Queue 3); with no counted loss the two
    agree."""
    rho_cand = rho_e[sub_src.long()]
    owned = rho_cand >= 0.0
    return rho_cand.clamp(min=0.0), torch.where(owned, w_sub, 0.0)


def slab_step_body(cfg: SphConfig, group: SlabGroup, p_cap: int, h_cap: int,
                   m_cap: int, chunk: int, sweeps: str,
                   zsplit: tuple[int, ...], lazy: bool, sub_len: int,
                   carry: LazySlabCarry
                   ) -> tuple[LazySlabCarry, torch.Tensor]:
    """One physics step on this rank's slab: the per-rank counterpart of the
    JAX engine's ``shard_map`` body.  Returns the new carry and the [9] f32
    diagnostic vector (identical on every rank)."""
    dev = group.device
    d = group.rank
    nxny = cfg.grid_nx * cfg.grid_ny
    slab_lo, slab_hi = zsplit[d] * nxny, zsplit[d + 1] * nxny
    fr = prepare_frame(cfg, group, p_cap, h_cap, m_cap, sweeps, zsplit, lazy,
                       sub_len, carry)
    fields_s, cid_s, cnt2, ext, tabs = (
        fr.fields_s, fr.cid_s, fr.count, fr.ext, fr.tabs)
    row_valid = fields_s[:, _OID] >= 0.0
    capped = bool(cfg.capped_candidates) and sweeps == "pallas"
    fused = capped and bool(cfg.capped_fused)

    # ---- sweeps ------------------------------------------------------------
    pos_i = fields_s[:, _POS]
    vel_i = fields_s[:, _VEL]
    mass_i = fields_s[:, _MASS]
    if capped:
        sub_src, cand_cid, w_sub, sub_dropped, sub_band = tabs
        g8 = ext[sub_src.long()]     # one gather, shared by the step's sweeps
        trunc = sub_dropped
        if fused:
            rho_l = scatter_sub_rho(
                ss.density_sub_local(cfg, g8, sub_src, cand_cid, w_sub,
                                     sub_band),
                sub_src, cand_cid, h_cap, p_cap)
        else:
            rho_l, nc_l = ss.density_local_capped(
                cfg, ext, g8, sub_src, w_sub, h_cap, p_cap, sub_band)
    elif sweeps == "pallas":
        band, = tabs
        rho_l, nc_l = ss.density_local(cfg, ext, h_cap, p_cap, band)
        trunc = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        rng_s, rng_e = tabs
        own_idx = h_cap + torch.arange(p_cap, dtype=torch.int32, device=dev)
        pos_e, vel_e, mass_e = ext[:, _POS], ext[:, _VEL], ext[:, _MASS]
        rho_l, nc_l, trunc_rows = celllist.density_rows(
            cfg, pos_e, mass_e, rng_s, rng_e, own_idx, pos_i, mass_i,
            chunk=min(chunk, p_cap))
        trunc = trunc_rows.sum()

    # the force sweep needs the halo rows' densities: the same edge windows
    rho_e = exchange_rho(group, rho_l, cnt2, h_cap)

    if fused:
        rho_cand, w_cand = fused_candidates(rho_e, sub_src, w_sub)
        acc_l, rho_l, nc_l = ss.fused_local_capped(
            cfg, ext, g8, rho_cand, sub_src, w_cand, h_cap, p_cap, sub_band)
    elif capped:
        acc_l = ss.force_local_capped(cfg, ext, g8, rho_e, rho_l, sub_src,
                                      w_sub, h_cap, p_cap, sub_band)
    elif sweeps == "pallas":
        acc_l = ss.force_local(cfg, ext, rho_e, rho_l, h_cap, p_cap, band)
    else:
        acc_l = celllist.force_rows(
            cfg, pos_e, vel_e, mass_e, rho_e, rng_s, rng_e, own_idx, pos_i,
            vel_i, rho_l, chunk=min(chunk, p_cap))

    # ---- integrate: inert rows ride at a safe in-box point -----------------
    rv = row_valid[:, None]
    safe = torch.tensor(cfg.central_pos, dtype=torch.float32, device=dev)
    acc_l = torch.where(rv, acc_l, 0.0)
    local_state = ParticleState(
        position=torch.where(rv, pos_i, safe),
        velocity=torch.where(rv, vel_i, 0.0),
        mass=torch.where(row_valid, mass_i, 0.0),
        density=rho_l, acceleration=acc_l, neighbor_count=nc_l)
    new_state, tally = kdk_integrate(cfg, local_state, acc_l)
    new_fields = torch.cat([new_state.position, new_state.velocity,
                            mass_i[:, None], fields_s[:, _OID:_OID + 1]],
                           dim=1)
    new_fields = torch.where(rv, new_fields, _inert(1, dev))

    # ---- diagnostics: one psum of [10], one pmax of [2] --------------------
    # the counts are summed exactly (f64); |L| is the norm of the summed
    # vector, not a sum of per-rank norms
    nc_w = torch.where(row_valid, nc_l, 0)
    top_plane = row_valid & (cid_s >= slab_hi - nxny)
    bot_plane = row_valid & (cid_s < slab_lo + nxny)
    counts = torch.stack([row_valid.sum(), nc_w.sum(), top_plane.sum(),
                          bot_plane.sum()]).double()
    halo_missed = ((counts[2] - h_cap).clamp(min=0)
                   + (counts[3] - h_cap).clamp(min=0))
    S = group.psum(torch.cat([
        torch.stack([tally.kinetic, tally.potential]).double(),
        tally.l_vec.double(), counts[0:2],
        torch.stack([trunc.double(), halo_missed]),
        torch.tensor([float(fr.lost)], dtype=torch.float64, device=dev)]))
    extrema = group.pmax(torch.stack([
        nc_w.max(), -torch.where(row_valid, nc_l, 1 << 30).min()]).long())
    diag = torch.cat([
        S[0:2].float(), torch.linalg.norm(S[2:5]).float()[None],
        (S[6].float() / S[5].clamp(min=1.0).float())[None],
        torch.stack([extrema[0], -extrema[1]]).float(), S[7:10].float()])
    new_carry = LazySlabCarry(
        fields=new_fields, count=cnt2, pos_bin=fr.pos_bin, cid=cid_s,
        tabs=tabs, steps_since=0 if fr.need else carry.steps_since + 1,
        rebin_count=carry.rebin_count + int(fr.need))
    return new_carry, diag


def _table_zeros(cfg: SphConfig, sweeps: str, p_cap: int, sub_len: int = 0,
                 device=None) -> tuple:
    """Placeholder frozen tables for the carry before the first rebin."""
    i32 = dict(dtype=torch.int32, device=device)
    if sweeps != "pallas":
        return (torch.zeros(p_cap, 9, **i32), torch.zeros(p_cap, 9, **i32))
    if not cfg.capped_candidates:
        return (ss.SlabBand(
            torch.zeros(cfg.num_cells + 1, **i32), torch.zeros(p_cap, **i32),
            torch.zeros(0, dtype=torch.int64, device=device), 0, 0),)
    return (torch.zeros(sub_len, **i32), torch.zeros(sub_len, **i32),
            torch.zeros(sub_len, dtype=torch.float32, device=device),
            torch.zeros((), **i32),
            ss.SubBand(torch.zeros(cfg.num_cells + 1, **i32),
                       torch.zeros(p_cap, **i32)))


def init_lazy_slab(cfg: SphConfig, group: SlabGroup, carry: SlabCarry,
                   p_cap: int, sweeps: str = "celllist",
                   sub_len: int = 0) -> LazySlabCarry:
    """Wrap a freshly distributed store with empty frozen structure;
    ``steps_since = -1`` makes the first step migrate, sort and build."""
    dev = group.device
    return LazySlabCarry(
        fields=carry.fields, count=carry.count,
        pos_bin=torch.zeros(p_cap, 3, dtype=torch.float32, device=dev),
        cid=torch.zeros(p_cap, dtype=torch.int32, device=dev),
        tabs=_table_zeros(cfg, sweeps, p_cap, sub_len, dev),
        steps_since=-1, rebin_count=0)


def derive_sub_len_slab(cfg: SphConfig, state: ParticleState, ndev: int,
                        zsplit: tuple[int, ...], margin: float = 1.15) -> int:
    """Host-side: bound the densest rank's kept-candidate count (own slab
    + both halo planes) for the capped engine; 128-rounded."""
    if not cfg.capped_candidates:
        return 0
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position)).cpu().numpy()
    occ = np.bincount(cid, minlength=cfg.num_cells)
    kept = np.minimum(occ, cfg.capped_candidates)
    nxny = cfg.grid_nx * cfg.grid_ny
    per_plane = kept.reshape(cfg.grid_nz, nxny).sum(axis=1)
    worst = 0
    for d in range(ndev):
        lo, hi = zsplit[d], zsplit[d + 1]
        own = per_plane[lo:hi].sum()
        halo = ((per_plane[lo - 1] if lo > 0 else 0)
                + (per_plane[hi] if hi < cfg.grid_nz else 0))
        worst = max(worst, int(own + halo))
    return -(-int(worst * margin + 128) // 128) * 128


def rank_counts(group: SlabGroup, carry) -> list[int]:
    """Every rank's valid-row count (a collective)."""
    c = torch.tensor([carry.count], dtype=torch.int64, device=group.device)
    return group.all_gather(c).reshape(-1).tolist()


def slab_imbalance(counts) -> float:
    """max/mean ratio of per-rank valid-row counts (1.0 = perfect)."""
    counts = np.asarray(counts, dtype=np.float64)
    return float(counts.max() / max(counts.mean(), 1.0))


def maybe_rebalance(cfg: SphConfig, group: SlabGroup, carry, n: int,
                    threshold: float = 1.5, headroom: float = 1.5):
    """Re-partition when the per-rank load imbalance exceeds ``threshold``
    (call between blocks of steps): collect the store over the group,
    derive a fresh occupancy-weighted split, caps and capped sub-frame
    bound from the current state, and re-distribute.

    Returns ``(carry, zsplit, caps, sub_len, changed)``; when ``changed``
    the caller builds a new step function for them.  Every rank takes the
    same branch (the counts are all-gathered).
    """
    if slab_imbalance(rank_counts(group, carry)) <= threshold:
        return carry, None, None, None, False
    state = collect(group, carry, n)
    ndev = group.world
    zsplit = derive_zsplit(cfg, state, ndev)
    caps = derive_slab_caps(cfg, state, ndev, headroom=headroom, zsplit=zsplit)
    sub_len = derive_sub_len_slab(cfg, state, ndev, zsplit)
    new_carry = distribute(cfg, state, group, caps[0], zsplit=zsplit)
    return new_carry, zsplit, caps, sub_len, True


def _diagnostics(dv: torch.Tensor) -> StepDiagnostics:
    """[..., 9] diagnostic vector(s) -> StepDiagnostics."""
    zeros = torch.zeros(dv.shape[:-1], dtype=torch.int32, device=dv.device)
    return StepDiagnostics(
        kinetic_energy=dv[..., 0], potential_energy=dv[..., 1],
        angular_momentum=dv[..., 2], neighbor_mean=dv[..., 3],
        neighbor_max=dv[..., 4].to(torch.int32),
        neighbor_min=dv[..., 5].to(torch.int32),
        overflow_cells=zeros,
        truncated_ranges=dv[..., 6].to(torch.int32),
        halo_dropped=dv[..., 7].to(torch.int32),
        migration_dropped=dv[..., 8].to(torch.int32))


def frame_sub_len(cfg: SphConfig, sweeps: str, p_cap: int, h_cap: int,
                  sub_len: int | None) -> int:
    """The capped sub frame's length: ``sub_len`` (None or 0 = the whole
    extended frame) capped at the extended frame; 0 when not capped."""
    if not (cfg.capped_candidates and sweeps == "pallas"):
        return 0
    e = p_cap + 2 * h_cap
    return min(sub_len or e, e)


def make_slab_step(cfg: SphConfig, group: SlabGroup, p_cap: int, h_cap: int,
                   m_cap: int, chunk: int | None = None,
                   sweeps: str = "celllist",
                   zsplit: tuple[int, ...] | None = None, lazy: bool = True,
                   sub_len: int | None = None, scan_block: int = 0
                   ) -> Callable[[SlabCarry | LazySlabCarry],
                                 tuple[LazySlabCarry, StepDiagnostics]]:
    """This rank's distributed step (see the module docstring); every rank
    of ``group`` calls it once per step with the same arguments.

    ``sweeps="pallas"`` runs the CUDA sweep kernels (their plain twins on
    CPU tensors), which need p_cap and h_cap to be multiples of the block
    width; ``"celllist"`` the plain cell-list sweeps.  ``lazy=False``
    rebins (and migrates) every step.  ``scan_block=K`` (K > 1) advances K
    steps per call and returns diagnostics with a leading [K] axis.
    ``chunk`` is the cell-list sweeps' rows per chunk (default by device).

    Accepts a ``SlabCarry`` (initialised here) or the ``LazySlabCarry`` of
    a previous call; returns a ``LazySlabCarry``.
    """
    ndev = group.world
    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    zsplit = tuple(int(z) for z in zsplit)
    if (len(zsplit) != ndev + 1 or zsplit[0] != 0
            or zsplit[-1] != cfg.grid_nz
            or any(b - a < 2 for a, b in zip(zsplit, zsplit[1:]))):
        raise ValueError(f"invalid zsplit {zsplit}: need {ndev + 1} "
                         "monotone entries spanning [0, grid_nz], >= 2 "
                         "planes per device")
    if sweeps not in ("celllist", "pallas"):
        raise ValueError(f"unknown sweeps engine: {sweeps!r}")
    if cfg.capped_candidates and sweeps != "pallas":
        raise ValueError("capped_candidates needs the pallas slab sweeps "
                         "(the celllist slab path has no subsample)")
    if cfg.second_kick == "full":
        raise ValueError("the slab step requires second_kick in ('gravity', "
                         "'none')")
    if h_cap > p_cap:
        raise ValueError(f"h_cap {h_cap} > p_cap {p_cap}: the edge windows "
                         "are slices of the slab store")
    if sweeps == "pallas":
        if p_cap % 128 or h_cap % 128:
            raise ValueError("pallas sweeps need p_cap and h_cap % 128 == 0")
        if cfg.pallas_window_t <= 0:
            raise ValueError("pallas sweeps need pallas_window_t > 0 "
                             "(derive via ops.sweeps_t.derive_window_t)")
        sw._validate(cfg)
        if p_cap % sw._blane(cfg) or h_cap % sw._blane(cfg):
            raise ValueError("p_cap and h_cap must be multiples of "
                             "pallas_block_t (derive_slab_caps rounds "
                             "accordingly)")
    sub_len = frame_sub_len(cfg, sweeps, p_cap, h_cap, sub_len)
    if chunk is None:
        chunk = celllist.default_chunk(group.device)

    def one(carry: LazySlabCarry):
        return slab_step_body(cfg, group, p_cap, h_cap, m_cap, chunk, sweeps,
                              zsplit, lazy, sub_len, carry)

    def step(carry):
        if not isinstance(carry, LazySlabCarry):
            carry = init_lazy_slab(cfg, group, carry, p_cap, sweeps, sub_len)
        if scan_block <= 1:
            carry, dv = one(carry)
            return carry, _diagnostics(dv)
        dvs = []
        for _ in range(scan_block):
            carry, dv = one(carry)
            dvs.append(dv)
        return carry, _diagnostics(torch.stack(dvs))

    return step


def run_slab_steps(group: SlabGroup, cfg: SphConfig, state, caps, zsplit,
                   steps: int, sweeps: str = "celllist",
                   sub_len: int | None = None, lazy: bool = True,
                   rebalance: tuple[int, float] | None = None) -> dict:
    """Distribute ``state`` (a ParticleState or a ``state_to_numpy`` dict),
    run ``steps`` slab steps on every rank of ``group``, collect.

    ``rebalance=(block, threshold)`` calls ``maybe_rebalance`` after every
    ``block`` steps.  Returns plain numpy / Python values (``spawn_ranks``
    pickles them): the per-step diagnostics, the ranks' counts after each
    step, the rebins, the rebalances, the collected final state, whether
    every original id is held exactly once, this rank's live halo rows
    (nl, nr) of the exact band tables (None in other modes) and the slab
    kernel wrappers' launch counts in this process.
    """
    if isinstance(state, dict):
        state = state_from_numpy(state, group.device)
    n = state.n
    caps = tuple(caps)
    carry = distribute(cfg, state, group, caps[0], zsplit)
    make = lambda caps, zs, sl: make_slab_step(
        cfg, group, *caps, sweeps=sweeps, zsplit=zs, lazy=lazy, sub_len=sl)
    step = make(caps, zsplit, sub_len)
    diags, counts, rebins, rebalanced = [], [], 0, 0
    for i in range(steps):
        carry, d = step(carry)
        diags.append(d)
        counts.append(rank_counts(group, carry))
        rebins += carry.steps_since == 0
        if rebalance and (i + 1) % rebalance[0] == 0:
            carry, zs2, caps2, sub2, changed = maybe_rebalance(
                cfg, group, carry, n, threshold=rebalance[1])
            if changed:
                caps, zsplit = caps2, zs2
                step = make(caps, zsplit, sub2 or sub_len)
                rebalanced += 1
    rows = group.all_gather(carry.fields).reshape(-1, _NCOLS).cpu().numpy()
    pos, vel, mass = collect_rows(rows, n)
    oid = rows[:, _OID][rows[:, _OID] >= 0].astype(np.int64)
    # the exact band tables (a rebalance on the last step leaves a fresh
    # SlabCarry, without tables)
    band = (carry.tabs[0] if sweeps == "pallas" and not cfg.capped_candidates
            and isinstance(carry, LazySlabCarry) else None)
    return dict(
        band_halo=None if band is None else (band.nl, band.nr),
        launches={w.__name__: w.launches for w in ss.WRAPPERS},
        diags=diagnostics_rows(diags),
        counts=counts, rebins=rebins, rebalanced=rebalanced,
        caps=caps, zsplit=zsplit, position=pos, velocity=vel, mass=mass,
        ids_once=bool((np.bincount(oid, minlength=n) == 1).all()))


def run_slab_jobs(group: SlabGroup, jobs: list[dict]) -> list[dict]:
    """``run_slab_steps`` for each job's keyword arguments, in order (one
    spawn of ranks for several runs)."""
    return [run_slab_steps(group, **job) for job in jobs]


class SlabRanks:
    """A ``comm.RankPool`` worker: this rank's slab of a ``run --devices N
    --partition slab``: the host loop of the JAX CLI's slab ``run``
    (``cli.py:179-202``), one step at a time (the JAX CLI's K-step scan
    amortises dispatch on the TPU; here it would loop the same step).
    Replies are plain values; the diagnostics and the collected state come
    from rank 0 (None from the others)."""

    def __init__(self, group: SlabGroup, cfg_json: str, state: dict,
                 zsplit: tuple[int, ...], caps: tuple[int, int, int],
                 sweeps: str, sub_len: int | None):
        self.group, self.sweeps = group, sweeps
        self.zsplit, self.caps, self.sub_len = tuple(zsplit), tuple(caps), sub_len
        self.cfg = SphConfig.from_json(cfg_json)
        st = state_from_numpy(state, group.device)
        self.n = st.n
        self.carry = distribute(self.cfg, st, group, self.caps[0], self.zsplit)
        self._make()

    def _make(self) -> None:
        self.step_fn = make_slab_step(
            self.cfg, self.group, *self.caps, sweeps=self.sweeps,
            zsplit=self.zsplit, sub_len=self.sub_len)

    def step(self, n: int) -> dict | None:
        diags = []
        for _ in range(n):
            self.carry, d = self.step_fn(self.carry)
            diags.append(d)
        return diagnostics_rows(diags) if self.group.rank == 0 else None

    def collect(self) -> dict | None:
        """The state in the caller's order (a collective)."""
        st = collect(self.group, self.carry, self.n)
        return state_to_numpy(st) if self.group.rank == 0 else None

    def rebalance(self, threshold: float):
        """``maybe_rebalance`` at ``threshold``: (p_cap, zsplit) when it
        re-partitioned, else None.  A capped pallas run takes the new
        sub-frame bound (the t=0 one goes stale with the partition)."""
        carry, zsplit, caps, sub_len, changed = maybe_rebalance(
            self.cfg, self.group, self.carry, self.n, threshold=threshold)
        if not changed:
            return None
        if self.sweeps == "pallas" and self.cfg.capped_candidates:
            self.sub_len = sub_len
        self.carry, self.zsplit, self.caps = carry, zsplit, caps
        self._make()
        return caps[0], zsplit

    def rebuild(self, cfg_json: str) -> None:
        """A new config: the store is kept, and the next step migrates,
        sorts and builds its tables afresh under it."""
        self.cfg = SphConfig.from_json(cfg_json)
        self.carry = SlabCarry(self.carry.fields, self.carry.count)
        self._make()

    def report(self) -> dict:
        """This rank's launch counts (the slab kernels' wrappers), its valid
        rows, and the live halo rows (nl, nr) of the exact band tables
        (None in other modes)."""
        band = (self.carry.tabs[0] if isinstance(self.carry, LazySlabCarry)
                and self.sweeps == "pallas"
                and not self.cfg.capped_candidates else None)
        return dict(launches={w.__name__: w.launches for w in ss.WRAPPERS},
                    count=self.carry.count,
                    band_halo=None if band is None else (band.nl, band.nr))
