"""Capped ("Subsets") mode of the torch package against the JAX package.

Scene: the 1024-particle splash on a 16^3 grid of 1.25h cells, window 64,
block 256, K_c = 4 (the cap binds: about 7 neighbors per particle against
12 exact).  The JAX sweeps run their Pallas kernels in interpreter mode, the
torch wrappers their plain twins (CPU tensors); each JAX reference is
computed once per module.  Bars: the kept set, sort order and window tables
bit-equal; neighbor counts equal; rho rel-L2 <= 1e-6; acc rel-L2 <= 1e-4;
six lazy steps within 1e-5 in positions and velocities.
"""

from functools import partial

import jax
import jax.numpy as jnp
import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import lazy as jlazy
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise as tpair
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import (cell_coords,
                                                               linear_cell_id)
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores (on an
# 8-core host the torch test files took 682 s with them, 55 s with one).
torch.set_num_threads(1)

RHO_BAR, ACC_BAR, STATE_BAR = 1e-6, 1e-4, 1e-5
STEPS = 6
SCENE = dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16,
             cell_size_factor=1.25, pallas_window_t=64, pallas_block_t=256,
             capped_candidates=4, pallas_interpret=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(**kw):
    jc, js = jscene("splash", **{**SCENE, **kw})
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def capped():
    """Configs at the derived sub-frame length, both prepared frames, and
    the JAX capped sweeps' outputs."""
    jc, js, tc, ts = _scenes()
    s_len = jpt.derive_sub_len(jc, js)
    jc, tc = jc.replace(capped_sub_len=s_len), tc.replace(capped_sub_len=s_len)
    p_j = jax.jit(partial(jpt.prepare_t, jc))(js)
    rho_j, nc_j = jax.jit(partial(jpt.density_sweep_t, jc))(p_j)
    acc_j = jax.jit(partial(jpt.force_sweep_t, jc))(p_j, rho_j)
    return dict(jc=jc, js=js, tc=tc, ts=ts, p_j=p_j,
                p_t=sweeps_t.prepare_t(tc, ts), rho_j=rho_j, nc_j=nc_j,
                acc_j=acc_j)


@pytest.mark.parametrize("idx", [
    [0, 1, 2, 3, 7, 255, 65535, 65536],
    [(1 << 24) - 1, 1 << 24, 1 << 30, (1 << 31) - 2, (1 << 31) - 1],
    [1640531527, 2654435769 - (1 << 31), 123456789, 987654321],
])
def test_hash32_matches_jax_at_wrap_edges(idx):
    got = sweeps_t._hash32(torch.tensor(idx, dtype=torch.int32))
    _eq(got, jpt._hash32(jnp.asarray(idx, jnp.int32)))


@pytest.mark.parametrize("hb", [4, 7, 8, 13])
def test_capped_sort_branches_match_jax(hb):
    """Both sort forms: the packed (cid << hb | top hash bits) key for
    hb >= 8 and the two-key (cid, hash) sort below, ties by input row."""
    rng = np.random.default_rng(hb)
    n = 4096
    cid = rng.integers(0, 40, n).astype(np.int32)
    jcid, iota = jnp.asarray(cid), jnp.arange(n, dtype=jnp.int32)
    if hb >= 8:
        packed = (jcid << hb) | (jpt._hash32(iota) >> (31 - hb))
        packed_s, order_j = jax.lax.sort((packed, iota), num_keys=1)
        cid_j = packed_s >> hb
    else:
        cid_j, _, order_j = jax.lax.sort((jcid, jpt._hash32(iota), iota),
                                         num_keys=2)
    cid_t, order_t = sweeps_t._capped_order(torch.from_numpy(cid), hb)
    _eq(order_t, order_j)
    _eq(cid_t, cid_j)


def test_run_rank_occ_matches_jax():
    cid = np.sort(np.random.default_rng(0).integers(0, 50, 2000)).astype(np.int32)
    rank_t, occ_t = sweeps_t._run_rank_occ(torch.from_numpy(cid))
    rank_j, occ_j = jpt._run_rank_occ(jnp.asarray(cid))
    _eq(rank_t, rank_j)
    _eq(occ_t, occ_j)


def test_derive_sub_len_and_window_match_jax(capped):
    jc, js, tc, ts = (capped[k] for k in ("jc", "js", "tc", "ts"))
    s_len = sweeps_t.derive_sub_len(tc, ts)
    assert s_len == jpt.derive_sub_len(jc, js) and 0 < s_len < ts.n
    assert sweeps_t.derive_window_t(tc, ts) == jpt.derive_window_t(jc, js)
    exact_t, exact_j = tc.replace(capped_candidates=0), jc.replace(
        capped_candidates=0)
    assert sweeps_t.derive_sub_len(exact_t, ts) == 0
    assert (sweeps_t.derive_window_t(exact_t, ts)
            == jpt.derive_window_t(exact_j, js)
            > sweeps_t.derive_window_t(tc, ts))


@pytest.mark.parametrize("s_len", ["derived", 256])
def test_prepare_capped_bit_equal(capped, s_len):
    """order, the kept set and its cids, reweighted masses and the overflow
    count equal JAX's, and the bands (two-pass and the fused pre-pass's)
    are the masked rows of JAX's window tables; 256 rows overflow."""
    jc, js, tc, ts = (capped[k] for k in ("jc", "js", "tc", "ts"))
    if s_len != "derived":
        jc, tc = jc.replace(capped_sub_len=s_len), tc.replace(capped_sub_len=s_len)
    jc, tc = jc.replace(capped_fused=True), tc.replace(capped_fused=True)
    p_j = jax.jit(partial(jpt.prepare_t, jc))(js)
    p_t = sweeps_t.prepare_t(tc, ts)
    for name in ("order", "sub_perm", "wm_sub", "sub_dropped", "pos_s",
                 "mass_s"):
        _eq(getattr(p_t, name), getattr(p_j, name))
    jax_windows.assert_prepared(tc, p_t, p_j.ws, p_j.wc, p_j.ws_sub,
                                p_j.wc_sub)
    _eq(p_t.cid, np.asarray(p_j.cid_f).astype(np.int32))
    kept = np.asarray(p_j.cand_cid_f) >= 0
    _eq(p_t.cand_cid[kept], np.asarray(p_j.cand_cid_f)[kept].astype(np.int32))
    assert (p_t.cand_cid[~kept] == sweeps_t.TAIL_CID).all()
    dropped = int(p_t.sub_dropped)
    assert (dropped > 0) == (s_len == 256), dropped


def test_capped_sweeps_match_jax(capped):
    tc, ts, p_t = capped["tc"], capped["ts"], capped["p_t"]
    rho_t, nc_t = sweeps_t.density_sweep_t(tc, p_t)
    _eq(nc_t, capped["nc_j"])
    assert _rel(rho_t.numpy(), capped["rho_j"]) <= RHO_BAR
    # force from the same densities on both sides
    acc_t = sweeps_t.force_sweep_t(tc, p_t,
                                   torch.tensor(np.asarray(capped["rho_j"])))
    assert _rel(acc_t.numpy(), capped["acc_j"]) <= ACC_BAR
    # the cap binds: the exact sweep on the same state finds many more pairs
    exact = tc.replace(capped_candidates=0)
    _, nc_e = sweeps_t.density_sweep_t(exact, sweeps_t.prepare_t(exact, ts))
    assert nc_t.float().mean() < 0.85 * nc_e.float().mean()


def test_keep_all_cap_equals_exact():
    """K_c >= the largest cell occupancy keeps every particle with unit
    weights: the capped path then finds the exact path's pairs."""
    _, _, tc, ts = _scenes(gravity=(0.0, 0.0, 0.0))
    cid = linear_cell_id(tc, cell_coords(tc, ts.position))
    occ_max = int(torch.bincount(cid.long()).max())
    capped_cfg = tc.replace(capped_candidates=occ_max)
    acc_c, rho_c, aux_c = sweeps_t.compute_step_quantities(capped_cfg, ts)
    acc_e, rho_e, aux_e = sweeps_t.compute_step_quantities(
        tc.replace(capped_candidates=0), ts)
    nc_c, nc_e, trunc = (aux_c.neighbor_count, aux_e.neighbor_count,
                         aux_c.truncated_ranges)
    _eq(nc_c, nc_e.numpy())
    _eq(nc_c, tpair.neighbor_counts(tc, ts).numpy())
    assert int(trunc) == 0
    assert _rel(rho_c.numpy(), rho_e.numpy()) <= RHO_BAR
    assert _rel(acc_c.numpy(), acc_e.numpy()) <= ACC_BAR


def test_lazy_capped_steps_match_jax(capped):
    """Six lazy steps: the same rebin steps, order and kept set, bands the
    masked rows of JAX's tables, counts equal every step, state within
    1e-5, truncated_ranges equal."""
    jc, js, tc, ts = (capped[k] for k in ("jc", "js", "tc", "ts"))
    jcarry = jax.jit(partial(jlazy.init_lazy, jc))(js)
    jstep = jax.jit(partial(jlazy.lazy_step, jc))
    tcarry = tlazy.init_lazy(tc, ts)
    for k in range(STEPS):
        jcarry, jd = jstep(jcarry)
        tcarry, td = tlazy.lazy_step(tc, tcarry)
        assert tcarry.rebin_count == int(jcarry.rebin_count), f"step {k}"
        for name in ("order", "sub_perm", "wm_sub"):
            _eq(getattr(tcarry, name), getattr(jcarry, name))
        jax_windows.assert_prepared(tc, tcarry, jcarry.ws, jcarry.wc)
        _eq(tcarry.state.neighbor_count, jcarry.state.neighbor_count)
        assert _rel(tcarry.state.position.numpy(),
                    jcarry.state.position) <= STATE_BAR, f"step {k}"
        assert _rel(tcarry.state.velocity.numpy(),
                    jcarry.state.velocity) <= STATE_BAR, f"step {k}"
        assert int(td.truncated_ranges) == int(jd.truncated_ranges)
    assert tcarry.rebin_count >= 1, "no rebin in the run"
