"""The torch package's sweep twins against the JAX sublane Pallas sweeps.

The JAX kernels run in interpreter mode on the CPU (``pallas_interpret``);
on CPU tensors the torch wrappers run their plain twins, which the CUDA
kernels are held to on the card (``chip_smoke.py``).  Bars: neighbor counts
equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4 (the JAX force kernel reduces
through block-relative MXU dots, the twins sum pairs directly, so acc
differs by reassociation only).
"""

import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import pairwise as jpair
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise as tpair
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores (on an
# 8-core host the torch test files took 682 s with them, 55 s with one).
torch.set_num_threads(1)

RHO_BAR, ACC_BAR = 1e-6, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(**kw):
    base = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=64,
                pallas_interpret=True)
    base.update(kw)
    jc, js = jscene("splash", **base)
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


@pytest.mark.parametrize("block", [128, 256])
def test_sweeps_match_jax_interpret(block):
    jc, js, tc, ts = _scenes(pallas_block_t=block)
    p_j = jpt.prepare_t(jc, js)
    p_t = sweeps_t.prepare_t(tc, ts)
    assert np.asarray(p_j.wc).max() > 1, "want a multi-chunk window"

    rho_j, nc_j = jpt.density_sweep_t(jc, p_j)
    rho_t, nc_t = sweeps_t.density_sweep_t(tc, p_t)
    np.testing.assert_array_equal(nc_t.numpy(), np.asarray(nc_j))
    assert _rel(rho_t.numpy(), rho_j) <= RHO_BAR

    # force from the same densities on both sides
    acc_j = jpt.force_sweep_t(jc, p_j, rho_j)
    acc_t = sweeps_t.force_sweep_t(tc, p_t, torch.tensor(np.asarray(rho_j)))
    assert _rel(acc_t.numpy(), acc_j) <= ACC_BAR


def test_fused_cand_cols_match_jax_lanes():
    jc, js, tc, ts = _scenes()
    p_j = jpt.prepare_t(jc, js)
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.5, 2.0, js.n).astype(np.float32)
    rho[:5] = 0.0                              # the rho <= 0 guard
    src = np.arange(js.n, dtype=np.float32)
    cols_j = np.asarray(jpt.fused_cand_cols(jc, p_j.pos_s, p_j.vel_s, rho,
                                            p_j.mass_s, p_j.cid_f, src))
    cols_t = sweeps_t.fused_cand_cols(
        tc, torch.tensor(np.asarray(p_j.pos_s)),
        torch.tensor(np.asarray(p_j.vel_s)), torch.from_numpy(rho),
        torch.tensor(np.asarray(p_j.mass_s))).numpy()
    lanes = [0, 1, 2, 4, 5, 6, 7, 9, 10]
    np.testing.assert_array_equal(cols_t, cols_j[:js.n, lanes])


def test_step_quantities_match_pairwise_oracles():
    """Whole sweep path (sort, tables, both sweeps, gravity, CFL, unsort)
    against the torch and the JAX O(N^2) oracles."""
    jc, js, tc, ts = _scenes(num_particles=1024)
    acc, rho, aux = sweeps_t.compute_step_quantities(tc, ts)
    nc = aux.neighbor_count
    assert int(aux.truncated_ranges) == 0 and int(aux.overflow_cells) == 0
    rho_o = tpair.compute_density(tc, ts)
    np.testing.assert_array_equal(nc.numpy(),
                                  tpair.neighbor_counts(tc, ts).numpy())
    np.testing.assert_array_equal(nc.numpy(),
                                  np.asarray(jpair.neighbor_counts(jc, js)))
    assert _rel(rho.numpy(), rho_o.numpy()) <= RHO_BAR
    assert _rel(rho.numpy(), jpair.compute_density(jc, js)) <= RHO_BAR
    acc_o = tpair.compute_acceleration(tc, ts, rho_o)
    assert _rel(acc.numpy(), acc_o.numpy()) <= ACC_BAR
    acc_jo = jpair.compute_acceleration(jc, js, jpair.compute_density(jc, js))
    assert _rel(acc_o.numpy(), acc_jo) <= ACC_BAR


@pytest.mark.parametrize("kw", [
    {}, dict(capped_candidates=4, pallas_block_t=256),
    dict(capped_candidates=4, pallas_block_t=256, capped_fused=True)])
def test_wrappers_take_twin_on_cpu_only(kw):
    """CPU tensors run the twins without touching any launch counter (exact,
    capped and fused paths); a device that is neither cpu nor cuda raises
    instead of falling back."""
    _, _, tc, ts = _scenes(num_particles=256, **kw)
    p = sweeps_t.prepare_t(tc, ts)
    before = [w.launches for w in sweeps_t.WRAPPERS]
    sweeps_t.sweeps_sorted(tc, p)
    assert [w.launches for w in sweeps_t.WRAPPERS] == before
    meta = p._replace(pos_s=p.pos_s.to("meta"))
    with pytest.raises(ValueError, match="cuda"):
        sweeps_t.sweeps_sorted(tc, meta)


@pytest.mark.parametrize("kw,err", [
    (dict(pallas_groups=3), ValueError),
    (dict(capped_candidates=4, pallas_groups=2), ValueError),
    (dict(pallas_window_t=60), ValueError),
    (dict(grid_nx=2), ValueError),
])
def test_prepare_rejects_unported_or_invalid(kw, err):
    _, _, tc, ts = _scenes(num_particles=256)
    with pytest.raises(err):
        sweeps_t.prepare_t(tc.replace(**kw), ts)
