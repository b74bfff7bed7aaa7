"""Fused capped mode (``capped_fused``) of the torch package against the
JAX package, and against the port's own two-pass capped path.

Same scene as ``test_torch_capped.py``: the 1024-particle splash, 16^3 grid
of 1.25h cells, window 64, block 256, K_c = 4 at the derived sub-frame
length.  The JAX sweeps run in interpreter mode, the torch wrappers their
plain twins.  The pre-pass densities are compared on the kept sub rows only:
the tail rows' values feed candidates that never pass the cid mask.  Bars:
counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4, lazy state <= 1e-5;
the port's fused rho and counts equal its two-pass ones bit for bit.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import lazy as jlazy
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores (on an
# 8-core host the torch test files took 682 s with them, 55 s with one).
torch.set_num_threads(1)

RHO_BAR, ACC_BAR, STATE_BAR = 1e-6, 1e-4, 1e-5
STEPS = 6
SCENE = dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16,
             cell_size_factor=1.25, pallas_window_t=64, pallas_block_t=256,
             capped_candidates=4, capped_fused=True, pallas_interpret=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def fused():
    """Configs at the derived sub-frame length, both prepared frames, and
    the JAX pre-pass and fused sweep's outputs."""
    jc, js = jscene("splash", **SCENE)
    jc = jc.replace(capped_sub_len=jpt.derive_sub_len(jc, js))
    tc = TCfg.from_json(jc.to_json())
    ts = state_from_numpy(js.to_numpy(), device="cpu")
    p_j = jax.jit(partial(jpt.prepare_t, jc))(js)

    @jax.jit
    def sweeps(p):
        pv = jpt.gather_sub_pv(p)
        rho_sub = jpt.density_sub_t(jc, p, pv)
        return rho_sub, jpt.fused_sweep_t(jc, p, rho_sub, pv)

    rho_sub_j, (acc_j, rho_j, nc_j) = sweeps(p_j)
    p_t = sweeps_t.prepare_t(tc, ts)
    n_kept = int((np.asarray(p_j.cand_cid_f) >= 0).sum())
    return dict(jc=jc, js=js, tc=tc, ts=ts, p_j=p_j, p_t=p_t, n_kept=n_kept,
                rho_sub_j=rho_sub_j, acc_j=acc_j, rho_j=rho_j, nc_j=nc_j)


def test_density_sub_matches_jax_on_kept_rows(fused):
    tc, p_t, k = fused["tc"], fused["p_t"], fused["n_kept"]
    assert 0 < k < p_t.sub_perm.shape[0], "want a sub frame with a tail"
    rho_sub = sweeps_t.density_sub_t(tc, p_t, sweeps_t.gather_sub_pv(p_t))
    assert _rel(rho_sub[:k].numpy(), np.asarray(fused["rho_sub_j"])[:k]) <= RHO_BAR


def test_fused_sweep_matches_jax(fused):
    """K3's twin from the JAX pre-pass densities, then the whole fused
    pipeline (pre-pass + fused pass) from the port's own."""
    tc, p_t = fused["tc"], fused["p_t"]
    pv = sweeps_t.gather_sub_pv(p_t)
    rho_sub_j = torch.tensor(np.asarray(fused["rho_sub_j"]))
    for rho_sub in (rho_sub_j, sweeps_t.density_sub_t(tc, p_t, pv)):
        acc, rho, nc = sweeps_t.fused_sweep_t(tc, p_t, rho_sub, pv)
        _eq(nc, fused["nc_j"])
        assert _rel(rho.numpy(), fused["rho_j"]) <= RHO_BAR
        assert _rel(acc.numpy(), fused["acc_j"]) <= ACC_BAR


def test_fused_equals_two_pass(fused):
    """The fused pass's rho and counts are the two-pass capped ones bit for
    bit (same pairs, same op sequence); acc agrees to reassociation, its
    candidate densities coming from the pre-pass instead."""
    tc, p_t, k = fused["tc"], fused["p_t"], fused["n_kept"]
    acc_f, rho_f, nc_f = sweeps_t.sweeps_sorted(tc, p_t)
    acc_2, rho_2, nc_2 = sweeps_t.sweeps_sorted(tc.replace(capped_fused=False),
                                                p_t)
    _eq(nc_f, nc_2.numpy())
    _eq(rho_f, rho_2.numpy())
    assert _rel(acc_f.numpy(), acc_2.numpy()) <= ACC_BAR
    rho_sub = sweeps_t.density_sub_t(tc, p_t, sweeps_t.gather_sub_pv(p_t))
    assert _rel(rho_sub[:k].numpy(), rho_2[p_t.sub_perm[:k]].numpy()) <= RHO_BAR


def test_lazy_fused_steps_match_jax(fused):
    """Six lazy steps of the fused path: the same rebin steps, order, kept
    set and both table pairs, counts equal every step, state within 1e-5,
    truncated_ranges equal."""
    jc, js, tc, ts = (fused[k] for k in ("jc", "js", "tc", "ts"))
    jcarry = jax.jit(partial(jlazy.init_lazy, jc))(js)
    jstep = jax.jit(partial(jlazy.lazy_step, jc))
    tcarry = tlazy.init_lazy(tc, ts)
    for k in range(STEPS):
        jcarry, jd = jstep(jcarry)
        tcarry, td = tlazy.lazy_step(tc, tcarry)
        assert tcarry.rebin_count == int(jcarry.rebin_count), f"step {k}"
        for name in ("order", "ws", "wc", "sub_perm", "wm_sub", "ws_sub",
                     "wc_sub"):
            _eq(getattr(tcarry, name), getattr(jcarry, name))
        _eq(tcarry.state.neighbor_count, jcarry.state.neighbor_count)
        assert _rel(tcarry.state.position.numpy(),
                    jcarry.state.position) <= STATE_BAR, f"step {k}"
        assert _rel(tcarry.state.velocity.numpy(),
                    jcarry.state.velocity) <= STATE_BAR, f"step {k}"
        assert int(td.truncated_ranges) == int(jd.truncated_ranges)
    assert tcarry.rebin_count >= 1, "no rebin in the run"
