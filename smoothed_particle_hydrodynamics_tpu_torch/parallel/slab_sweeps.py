"""The slab engine's neighbor sweeps: K1, K2 and K3 of ``csrc/sweep_t.cu``
run over a rank's extended frame.

Counterpart of the six callers of ``_slab_chunked_call`` in the JAX
package's ``parallel/slabs.py`` (its Pallas call at line 570):
``_pallas_density_local`` (:494), ``_pallas_force_local`` (:588),
``_pallas_density_local_capped`` (:663), ``_pallas_force_local_capped``
(:704), ``_pallas_density_sub_local`` (:750) and
``_pallas_fused_local_capped`` (:792).

The candidates are the extended frame ``ext`` = [left halo | own slab |
right halo] (``h_cap + p_cap + h_cap`` rows, the halos from the ring
neighbours) or, in capped mode, its sub frame (the kept rows ``ext[sub_src]``).
The self rows are the own slab, rows ``[h_cap, h_cap + p_cap)`` of ``ext``,
so the capped K1, K2 and K3 pass ``self_base = h_cap``: self row i's own
id is its extended-frame row, the one self-exclusion compares with a
candidate's ``sub_src``.  This is the Pallas kernels' ``block_base =
h_cap // b + chunk``; the exact walks, over the live rows, pass the live
left-halo rows instead.  The TPU path splits each call into SMEM-sized chunks
of blocks, each with a reference point; here each caller launches its kernel
once per step.

Exact K1 and K2 are the band walks ``density_band_t``/``force_band_t`` of
``csrc/sweep_t.cu``.  Their candidates are the extended frame's LIVE rows,
compacted in order (``SlabBand.rows``; the wrappers gather their columns
from the raw frame's each step): a cell-start table over the raw frame
would hold its dead rows in real cells (the own dead run sits in the
slab's last cell, a short neighbour's in its own), and every band reaching
such a cell would walk them.  Own row i is live row ``nl + i`` (``self_base
= nl``, the live left-halo rows), and the own dead rows carry self cid
``NO_CELL``, so they walk nothing and write rho 0, count 0, acc 0; every
reader masks dead rows.  A band holds exactly the live rows of the JAX
engine's rod window over the raw frame that pass its cid mask, in order.

Capped K1 and K2 are the same band kernels over the sub frame
(``SubBand``): its kept rows lead in cid order and its unkept tail sits at
``num_cells``, so the search of its cids is the cell-start table and no
band reaches the tail.  Own row i keeps ``self_base = h_cap``, the
exclusion ``sub_src[j] != h_cap + i``, and the own dead rows carry self cid
``NO_CELL`` (they walk nothing: rho 0, count 0, acc 0).

The fused pair walks the same ``SubBand``.  K3 (``fused_band_t``) is capped
K2's walk with K1's sums added: the own rows over the sub frame, ``self_base
= h_cap``, the own dead rows ``NO_CELL``.  The pre-pass
(``density_band_t<kExclSrcSrc>``) walks the sub frame over itself: self cids
``cand_cid`` (``TAIL_CID`` on the unkept tail, whose bands are empty, so
they get the self term and count 0; ``scatter_sub_rho`` keeps only kept
rows), own id ``sub_src[i]``.

Every twin is ``sweeps_t``'s twin of its kernel on the kernel's own
arguments: the same band table, self cids and gathered candidates.

Dead rows (``[count, p_cap)`` of the slab) and the inert chain-end halos
sit at position 1e30 with mass 0: a pair with one of them has d^2 = inf,
which the kernels' ``d^2 < h^2`` test and the twins' ``torch.where`` reject
(a twin that multiplied by a mask would turn 0 * inf into NaN).

Each caller is ``<wrapper>(*<caller>_args(...))``: the ``*_args`` builders
assemble the candidate columns exactly as the JAX callers do (its pad rows
of cid -10 are not needed: the walks stop at the frame's end), and each
wrapper launches its kernel on CUDA tensors (counting the launch in
``<wrapper>.launches``) or runs its plain twin on CPU tensors
(``<wrapper>_plain`` runs the twin on any tensors).  Gravity and the CFL
clamp follow the sweep, as in the JAX callers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SphConfig
from ..ops import physics
from ..ops import sweeps_t as sw

_MASS = 6   # slab store column of the mass (``slabs._MASS``)


class SlabBand(NamedTuple):
    """The exact band kernels' view of a rank's extended frame, built at
    rebins (``slabs._band_tables``) and frozen with the bins."""

    cell_start: torch.Tensor  # [num_cells + 1] i32 first live row of each cell
    cid: torch.Tensor         # [p_cap] i32 own cids, NO_CELL from the count on
    rows: torch.Tensor        # [M] i64 extended-frame row of each live row
    nl: int                   # live left-halo rows: own row i is live nl + i
    nr: int                   # live right-halo rows (M = nl + count + nr)


class SubBand(NamedTuple):
    """The capped and fused band kernels' view of a rank's sub frame, built
    at rebins (``slabs._sub_band``) and frozen with the bins."""

    cell_start: torch.Tensor  # [num_cells + 1] i32 first kept sub row per cell
    cid: torch.Tensor         # [p_cap] i32 own cids, NO_CELL from the count on


# ---------------------------------------------------------------------------
# Kernel wrappers: each hands its kernel and its twin the same arguments
# ---------------------------------------------------------------------------

def _band(band: SlabBand | SubBand | None) -> SlabBand | SubBand:
    """The walks' candidates' table, or a ValueError: no sweep falls back
    to a window walk."""
    if band is None:
        raise ValueError("the slab band kernels need their candidates' "
                         "cell-start table (SlabBand or SubBand, from "
                         "prepare_frame)")
    return band


def _density_ext(cfg, pos_l, mass_l, cand_pos, cand_mass, band):
    """Exact K1's arguments: the own rows over the live rows of the raw
    frame's columns, gathered here."""
    band = _band(band)
    return (cfg, pos_l, mass_l, band.cid, band.cell_start,
            cand_pos[band.rows], cand_mass[band.rows], None, band.nl)


def density_ext_plain(cfg, pos_l, mass_l, cand_pos, cand_mass, band):
    return sw.density_t_plain(*_density_ext(cfg, pos_l, mass_l, cand_pos,
                                            cand_mass, band))


def density_ext(cfg: SphConfig, pos_l, mass_l, cand_pos, cand_mass,
                band: SlabBand | None):
    """Exact K1 of the own slab: (rho [p_cap], ncount [p_cap]) over the
    bands of the live rows (``band``)."""
    return sw.sweep(density_ext, sw.density_t_plain, sw._launch_density_band,
                    "density_band_t[slab]", *_density_ext(
                        cfg, pos_l, mass_l, cand_pos, cand_mass, band))


def _force_ext(cfg, pos_l, vel_l, rho_l, cand, band):
    band = _band(band)
    return (cfg, pos_l, vel_l, rho_l, cand[band.rows], band.cid,
            band.cell_start, None, band.nl)


def force_ext_plain(cfg, pos_l, vel_l, rho_l, cand, band):
    return sw.force_t_plain(*_force_ext(cfg, pos_l, vel_l, rho_l, cand, band))


def force_ext(cfg: SphConfig, pos_l, vel_l, rho_l, cand,
              band: SlabBand | None):
    """Exact K2 of the own slab: hydro acc [p_cap, 3] over the bands of the
    live rows of ``cand`` (gathered here)."""
    return sw.sweep(force_ext, sw.force_t_plain, sw._launch_force_band,
                    "force_band_t[slab]", *_force_ext(cfg, pos_l, vel_l,
                                                       rho_l, cand, band))


def _density_ext_capped(cfg, pos_l, mass_l, cand_pos, cand_mass, cand_src,
                        self_base, band):
    band = _band(band)
    return (cfg, pos_l, mass_l, band.cid, band.cell_start, cand_pos,
            cand_mass, cand_src, self_base)


def density_ext_capped_plain(cfg, pos_l, mass_l, cand_pos, cand_mass,
                             cand_src, self_base, band):
    return sw.density_t_plain(*_density_ext_capped(
        cfg, pos_l, mass_l, cand_pos, cand_mass, cand_src, self_base, band))


def density_ext_capped(cfg: SphConfig, pos_l, mass_l, cand_pos, cand_mass,
                       cand_src, self_base: int, band: SubBand | None):
    """Capped K1 over the extended frame's sub frame: (rho, ncount) over
    the bands of the sub frame's table (``band``)."""
    return sw.sweep(density_ext_capped, sw.density_t_plain,
                    sw._launch_density_band, "density_band_t<capped>[slab]",
                    *_density_ext_capped(cfg, pos_l, mass_l, cand_pos,
                                         cand_mass, cand_src, self_base,
                                         band))


def _force_ext_capped(cfg, pos_l, vel_l, rho_l, cand, cand_src, self_base,
                      band):
    band = _band(band)
    return (cfg, pos_l, vel_l, rho_l, cand, band.cid, band.cell_start,
            cand_src, self_base)


def force_ext_capped_plain(cfg, pos_l, vel_l, rho_l, cand, cand_src,
                           self_base, band):
    return sw.force_t_plain(*_force_ext_capped(
        cfg, pos_l, vel_l, rho_l, cand, cand_src, self_base, band))


def force_ext_capped(cfg: SphConfig, pos_l, vel_l, rho_l, cand, cand_src,
                     self_base: int, band: SubBand | None):
    """Capped K2 over the extended frame's sub frame: acc [p_cap, 3] over
    the sub frame's bands."""
    return sw.sweep(force_ext_capped, sw.force_t_plain,
                    sw._launch_force_band, "force_band_t<capped>[slab]",
                    *_force_ext_capped(cfg, pos_l, vel_l, rho_l, cand,
                                       cand_src, self_base, band))


def density_sub_pre_plain(cfg, pos_sub, mass_sub, wm_sub, cid_sub, src_sub,
                          band):
    return sw.density_pre_t_plain(cfg, pos_sub, mass_sub, wm_sub, cid_sub,
                                  src_sub, _band(band).cell_start)


def density_sub_pre(cfg: SphConfig, pos_sub, mass_sub, wm_sub, cid_sub,
                    src_sub, band: SubBand | None):
    """Fused path's pre-pass over the sub frame itself: rho [S] (the
    src-vs-src exclusion needs no offset) over the bands of the sub frame's
    table (``band``) for the self cids ``cid_sub``."""
    return sw.sweep(density_sub_pre, sw.density_t_plain,
                    sw._launch_density_band, "density_band_t<prepass>[slab]",
                    *sw._pre_args(cfg, pos_sub, mass_sub, wm_sub, cid_sub,
                                  src_sub, _band(band).cell_start))[0]


def _fused_ext(cfg, pos_l, vel_l, mass_l, cand, cand_src, self_base, band):
    band = _band(band)
    return (cfg, pos_l, vel_l, mass_l, band.cid, band.cell_start, cand,
            cand_src, self_base)


def fused_ext_plain(cfg, pos_l, vel_l, mass_l, cand, cand_src, self_base,
                    band):
    return sw.fused_t_plain(*_fused_ext(cfg, pos_l, vel_l, mass_l, cand,
                                        cand_src, self_base, band))


def fused_ext(cfg: SphConfig, pos_l, vel_l, mass_l, cand, cand_src,
              self_base: int, band: SubBand | None):
    """Fused capped K3 over the extended frame's sub frame: (acc, rho,
    ncount) of the own slab over the sub frame's bands (``band``) for the
    own cids ``band.cid``."""
    return sw.sweep(fused_ext, sw.fused_t_plain, sw._launch_fused_band,
                    "fused_band_t[slab]", *_fused_ext(
                        cfg, pos_l, vel_l, mass_l, cand, cand_src, self_base,
                        band))


WRAPPERS = (density_ext, force_ext, density_ext_capped, force_ext_capped,
            density_sub_pre, fused_ext)
for _w in WRAPPERS:
    _w.launches = 0


# ---------------------------------------------------------------------------
# The callers: frame assembly around the wrappers
# ---------------------------------------------------------------------------

def _own(ext: torch.Tensor, h_cap: int, p_cap: int):
    """(pos, vel, mass) of the own slab's rows, contiguous."""
    loc = ext[h_cap:h_cap + p_cap]
    return (loc[:, 0:3].contiguous(), loc[:, 3:6].contiguous(),
            loc[:, _MASS].contiguous())


def _finish(cfg: SphConfig, acc: torch.Tensor, pos: torch.Tensor
            ) -> torch.Tensor:
    """Hydro acc + central and uniform gravity, CFL-clamped."""
    acc = acc + physics.central_gravity(cfg, pos)
    acc = acc + torch.tensor(cfg.gravity, dtype=torch.float32,
                             device=acc.device)
    return physics.cfl_clamp(cfg, acc)


def density_local_args(cfg: SphConfig, ext, h_cap: int, p_cap: int,
                       band: SlabBand | None) -> tuple:
    """The raw frame's columns (views: the wrapper gathers the live rows)
    and the frozen ``band``."""
    pos, _, mass = _own(ext, h_cap, p_cap)
    return (cfg, pos, mass, ext[:, 0:3], ext[:, _MASS], band)


def density_local(cfg: SphConfig, ext, h_cap: int, p_cap: int,
                  band: SlabBand | None):
    """Exact density of the own slab: (rho [p_cap], ncount [p_cap])."""
    return density_ext(*density_local_args(cfg, ext, h_cap, p_cap, band))


def force_local_args(cfg: SphConfig, ext, rho_e, rho_l, h_cap: int,
                     p_cap: int, band: SlabBand | None) -> tuple:
    """The raw frame's force columns and the frozen ``band``."""
    pos, vel, _ = _own(ext, h_cap, p_cap)
    cand = sw.fused_cand_cols(cfg, ext[:, 0:3], ext[:, 3:6], rho_e,
                              ext[:, _MASS])
    return (cfg, pos, vel, rho_l, cand, band)


def force_local(cfg: SphConfig, ext, rho_e, rho_l, h_cap: int, p_cap: int,
                band: SlabBand | None) -> torch.Tensor:
    """Exact acceleration of the own slab [p_cap, 3]; ``rho_e`` holds the
    extended frame's densities (halo rows from the neighbours)."""
    args = force_local_args(cfg, ext, rho_e, rho_l, h_cap, p_cap, band)
    return _finish(cfg, force_ext(*args), args[1])


def density_local_capped_args(cfg: SphConfig, ext, g8, sub_src, w_sub,
                              h_cap: int, p_cap: int,
                              band: SubBand | None) -> tuple:
    pos, _, mass = _own(ext, h_cap, p_cap)
    return (cfg, pos, mass, g8[:, 0:3].contiguous(), g8[:, _MASS] * w_sub,
            sub_src, h_cap, band)


def density_local_capped(cfg: SphConfig, ext, g8, sub_src, w_sub,
                         h_cap: int, p_cap: int, band: SubBand | None):
    """Capped density of the own slab over the sub frame; ``g8 =
    ext[sub_src]`` is gathered once per step and shared with the force,
    ``band`` the sub frame's frozen table."""
    return density_ext_capped(*density_local_capped_args(
        cfg, ext, g8, sub_src, w_sub, h_cap, p_cap, band))


def force_local_capped_args(cfg: SphConfig, ext, g8, rho_e, rho_l, sub_src,
                            w_sub, h_cap: int, p_cap: int,
                            band: SubBand | None) -> tuple:
    pos, vel, _ = _own(ext, h_cap, p_cap)
    cand = sw.fused_cand_cols(cfg, g8[:, 0:3], g8[:, 3:6],
                              rho_e[sub_src.long()], g8[:, _MASS] * w_sub)
    return (cfg, pos, vel, rho_l, cand, sub_src, h_cap, band)


def force_local_capped(cfg: SphConfig, ext, g8, rho_e, rho_l, sub_src, w_sub,
                       h_cap: int, p_cap: int, band: SubBand | None
                       ) -> torch.Tensor:
    args = force_local_capped_args(cfg, ext, g8, rho_e, rho_l, sub_src,
                                   w_sub, h_cap, p_cap, band)
    return _finish(cfg, force_ext_capped(*args), args[1])


def density_sub_local_args(cfg: SphConfig, g8, sub_src, cand_cid, w_sub,
                           band: SubBand | None) -> tuple:
    mass = g8[:, _MASS].contiguous()
    return (cfg, g8[:, 0:3].contiguous(), mass, mass * w_sub, cand_cid,
            sub_src, band)


def density_sub_local(cfg: SphConfig, g8, sub_src, cand_cid, w_sub,
                      band: SubBand | None) -> torch.Tensor:
    """Fused path's pre-pass: capped density [S] of the sub-frame rows
    (self rows carry the true mass, candidates the reweighted one);
    ``band`` the sub frame's frozen table."""
    return density_sub_pre(*density_sub_local_args(cfg, g8, sub_src, cand_cid,
                                                   w_sub, band))


def fused_local_capped_args(cfg: SphConfig, ext, g8, rho_cand, sub_src,
                            w_sub, h_cap: int, p_cap: int,
                            band: SubBand | None) -> tuple:
    pos, vel, mass = _own(ext, h_cap, p_cap)
    cand = sw.fused_cand_cols(cfg, g8[:, 0:3], g8[:, 3:6], rho_cand,
                              g8[:, _MASS] * w_sub)
    return (cfg, pos, vel, mass, cand, sub_src, h_cap, band)


def fused_local_capped(cfg: SphConfig, ext, g8, rho_cand, sub_src, w_sub,
                       h_cap: int, p_cap: int, band: SubBand | None):
    """One fused pass: (acc, rho, ncount) of the own slab; ``rho_cand``
    holds each sub-frame row's pre-pass density (halo rows' from their
    owner), ``band`` the sub frame's frozen table."""
    args = fused_local_capped_args(cfg, ext, g8, rho_cand, sub_src, w_sub,
                                   h_cap, p_cap, band)
    acc, rho, ncount = fused_ext(*args)
    return _finish(cfg, acc, args[1]), rho, ncount
