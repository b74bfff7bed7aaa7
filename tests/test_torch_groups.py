"""Lane groups (``pallas_groups`` G in {1, 2, 4}) in the torch package
against the JAX package.

In JAX a block's lanes split into G spatial groups, each with its own rod
windows (``ops/pallas_step_t.py::_block_windows_t``, the (block, group,
rod) layout), merged in the kernels by ``_merge_cols``.  The port's sweeps
and twins walk each row's cell bands and read no window table, so G
changes nothing on its path; each band holds exactly the masked rows of
its group's window in JAX's tables at every G, on one GPU and on the slab
engine (``chip_smoke.py`` phase 17 holds the card's step at G = 2 and 4
bit-equal to G = 1).

Bars: bands against the JAX tables by brute force; step quantities against
JAX's Pallas kernels in interpreter mode on the 512-particle disk of
``tests/test_pallas_transposed.py``: neighbor counts equal, rho rel-L2 <=
1e-6, acc rel-L2 <= 1e-4 (the ROADMAP's bars; JAX reduces its force terms
through block-relative MXU dots, the twins sum pairs directly).
"""

import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise as tpair
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import NO_CELL
from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm
from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs as ts
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from test_torch_slabs import (FRAMES, _frame, _live_bands, _synthetic_cids,
                              _synthetic_ext)
from test_torch_slabs import _scenes as _slab_scenes

# the twins gain nothing from intra-op threads at these sizes
torch.set_num_threads(1)

RHO_BAR, ACC_BAR = 1e-6, 1e-4
GROUPS = [1, 2, 4]
# the sorted cid layouts: the reference's disk (2h cells, sparse) and the
# splash (1.25h cells, a packed pool under a drop), both with a tail block
SCENES = {"disk": dict(num_particles=4000),
          "splash": dict(num_particles=6000, cell_size_factor=1.25)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _pair(name, **kw):
    jc, jst = jscene(name, **kw)
    return (jc, jst, TCfg.from_json(jc.to_json()),
            state_from_numpy(jst.to_numpy(), device="cpu"))


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_block_windows_match_jax(name, block, groups):
    """``prepare_t``'s bands against JAX's [nblocks * G, 9] tables
    (``_block_windows_t``, (block, group, rod) order): each row's band is
    exactly its group's rod window rows that pass the cid mask, in order;
    and each group's window lies inside its block's G = 1 window."""
    jc, _, tc, tst = _pair(name, pallas_window_t=64, pallas_block_t=block,
                           pallas_groups=groups, **SCENES[name])
    p = sw.prepare_t(tc, tst)
    n = p.cid.shape[0]
    nblocks = -(-n // block)
    ws, wc = jax_windows.single_chip(tc, p.cid.numpy())
    assert ws.shape == (nblocks * groups, sw.NRODS)
    a, e = sw.band_ranges(tc, p.cid, p.cell_start)
    assert jax_windows.assert_bands(tc, ws, wc, p.cid, p.cid, a.numpy(),
                                    e.numpy(), n) == 0
    if groups > 1:
        ws1, wc1 = jax_windows.single_chip(tc.replace(pallas_groups=1),
                                           p.cid.numpy())
        lo1 = ws1.reshape(nblocks, 1, 9)
        hi1 = lo1 + 64 * wc1.reshape(nblocks, 1, 9)
        lo, cnt = ws.reshape(nblocks, groups, 9), wc.reshape(nblocks, groups, 9)
        inside = (lo >= lo1) & (lo + 64 * cnt <= hi1 + 64)
        assert bool(inside[cnt > 0].all())


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_derive_window_matches_jax(name, groups):
    jc, jst, tc, tst = _pair(name, pallas_groups=groups, **SCENES[name])
    assert sw.derive_window_t(tc, tst) == jpt.derive_window_t(jc, jst)


@pytest.mark.parametrize("groups", GROUPS)
def test_step_quantities_match_jax_interpret(groups):
    """The 512-particle disk of ``tests/test_pallas_transposed.py:41-47``:
    the JAX Pallas kernels in interpreter mode (their per-group windows and
    ``_merge_cols``) against the port's twins at the same G."""
    jc, jst, tc, tst = _pair("disk", num_particles=512,
                             pallas_layout="sublane", pallas_interpret=True,
                             pallas_window_t=96, pallas_groups=groups)
    acc_j, rho_j, aux_j = jpt.compute_step_quantities(jc, jst)
    acc_t, rho_t, aux_t = sw.compute_step_quantities(tc, tst)
    np.testing.assert_array_equal(aux_t.neighbor_count.numpy(),
                                  np.asarray(aux_j.neighbor_count))
    assert _rel(rho_t.numpy(), rho_j) <= RHO_BAR
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR


@pytest.mark.parametrize("groups", [2, 4])
def test_twins_at_groups_match_the_oracle_and_g1(groups):
    """A packed splash (~14 neighbors a row, multi-chunk windows at
    G = 1 in JAX's tables): the twins at G against the O(N^2) oracle (to
    the bars) and against G = 1 (bit-equal: the same bands)."""
    cfg, st = make_scene("splash", device="cpu", num_particles=2048,
                         cell_size_factor=1.25, pallas_window_t=64,
                         grid_nx=16, grid_ny=16, grid_nz=16,
                         gravity=(0.0, 0.0, 0.0), pallas_groups=groups)
    cid = sw.prepare_t(cfg, st).cid.numpy()
    assert int(jax_windows.single_chip(cfg.replace(pallas_groups=1),
                                       cid)[1].max()) > 1
    acc, rho, aux = sw.compute_step_quantities(cfg, st)
    acc1, rho1, aux1 = sw.compute_step_quantities(
        cfg.replace(pallas_groups=1), st)
    nc_o = tpair.neighbor_counts(cfg, st)
    rho_o = tpair.compute_density(cfg, st)
    acc_o = tpair.compute_acceleration(cfg, st, rho_o)
    assert float(nc_o.float().mean()) > 10
    assert torch.equal(aux.neighbor_count, nc_o)
    assert torch.equal(aux.neighbor_count, aux1.neighbor_count)
    assert _rel(rho, rho_o) <= RHO_BAR and torch.equal(rho, rho1)
    assert _rel(acc, acc_o) <= ACC_BAR and torch.equal(acc, acc1)


@pytest.mark.parametrize("ndev,d", FRAMES)
@pytest.mark.parametrize("groups", [2, 4])
def test_slab_tables_match_jax(ndev, d, groups):
    """The slab engine's exact band table against JAX's frozen tables at G
    (``_pallas_tables``, dead-row aware and plane-local): each live own
    row's band holds its group's rod window rows that pass the cid mask and
    are live, in order; every (block, group) row of a dead block is empty in
    JAX's table, and the port's dead rows walk nothing; the placeholder
    table of the carry before its first rebin has the band's layout."""
    _, _, tc, tst = _slab_scenes()
    tc = tc.replace(pallas_window_t=64, pallas_groups=groups)
    f = _frame(tc, tst, ndev, d)
    ws, wc = jax_windows.slab(tc, f["cid_s"], f["cid_ext"], f["h_cap"],
                              f["p_cap"], f["cnt"], f["slab_hi"], f["base"],
                              f["loc"])
    band, a, e = _live_bands(tc, f)
    valid = (f["ext"][:, 7] >= 0).numpy()
    jax_windows.assert_bands(tc, ws, wc, f["cid_s"], f["cid_ext"], a, e,
                             f["ext"].shape[0], band.rows.numpy(), valid,
                             f["cnt"])
    nblocks = f["p_cap"] // sw._blane(tc)
    assert ws.shape == (nblocks * groups, sw.NRODS)
    dead = np.arange(nblocks) * sw._blane(tc) >= f["cnt"]
    assert not wc.reshape(nblocks, groups * 9)[dead].any()
    assert (band.cid[f["cnt"]:] == NO_CELL).all()
    # the placeholder table of the carry before its first rebin
    zeros, = ts._table_zeros(tc, "pallas", f["p_cap"])
    assert zeros.cid.shape == band.cid.shape
    assert zeros.cell_start.shape == band.cell_start.shape


@pytest.mark.parametrize("case", ["dead", "mid_slab"])
def test_slab_tables_synthetic_match_jax(case):
    """The JAX tests' hand-built layouts at G = 2: the live own rows' bands
    against JAX's tables of the same cids."""
    jc, _ = jscene("dam_break", num_particles=4096, grid_nx=16, grid_ny=16,
                   grid_nz=16, pallas_window_t=64, pallas_groups=2)
    tc = TCfg.from_json(jc.to_json())
    cid_loc, cid_ext, h_cap, p_cap, cnt, slab_hi, base, loc = \
        _synthetic_cids(case)
    ws, wc = jax_windows.slab(tc, cid_loc, cid_ext, h_cap, p_cap, cnt,
                              slab_hi, base, loc)
    ext = _synthetic_ext(cid_ext, h_cap, p_cap, cnt)
    f = dict(ext=ext, cid_ext=torch.from_numpy(cid_ext),
             cid_s=torch.from_numpy(cid_loc), cnt=cnt, h_cap=h_cap)
    band, a, e = _live_bands(tc, f)
    jax_windows.assert_bands(tc, ws, wc, cid_loc, cid_ext, a, e,
                             cid_ext.shape[0], band.rows.numpy(),
                             (ext[:, 7] >= 0).numpy(), cnt)


@pytest.mark.parametrize("kw,msg", [
    (dict(pallas_groups=3), "pallas_groups must be 1, 2, or 4"),
    (dict(pallas_groups=8), "pallas_groups must be 1, 2, or 4"),
    (dict(capped_candidates=4, pallas_groups=2),
     "capped_candidates currently requires pallas_groups=1"),
])
def test_invalid_groups_raise_jax_errors(kw, msg):
    """G outside {1, 2, 4}, and capped mode with G != 1, raise JAX's
    ValueErrors, on one GPU and on the slab engine."""
    jc, jst, tc, tst = _pair("splash", num_particles=512,
                             cell_size_factor=1.25, pallas_window_t=64)
    with pytest.raises(ValueError, match=msg):
        jpt.prepare_t(jc.replace(**kw), jst)
    with pytest.raises(ValueError, match=msg):
        sw.prepare_t(tc.replace(**kw), tst)
    with comm.local_group("cpu") as group, \
            pytest.raises(ValueError, match=msg):
        ts.make_slab_step(tc.replace(**kw), group, 512, 128, 0,
                          sweeps="pallas")
