"""Torch package against the JAX package: initial conditions, binning and
window tables, KDK integration with reflection, energy tallies."""

import inspect

import jax.numpy as jnp
import jax_windows
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import init as jinit
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import grid as jgrid
from smoothed_particle_hydrodynamics_tpu.ops import integrate as jint
from smoothed_particle_hydrodynamics_tpu.ops import pallas_step_t as jpt
from smoothed_particle_hydrodynamics_tpu.state import ParticleState as JState
from smoothed_particle_hydrodynamics_tpu_torch import init as tinit
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene as tscene
from smoothed_particle_hydrodynamics_tpu_torch.ops import grid as tgrid
from smoothed_particle_hydrodynamics_tpu_torch.ops import integrate as tint
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.state import (
    ParticleState as TState, state_from_numpy, state_to_numpy)

SPLASH = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=64)


def _tcfg(jc):
    return TCfg.from_json(jc.to_json())


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_state_round_trip_bit_exact():
    _, js = jscene("splash", **SPLASH)
    d = js.to_numpy()
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for k, v in d.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v)


def test_state_from_numpy_defaults_to_the_card():
    """Like every entry point of the port, a carried state lands on the card
    unless the caller asks for the CPU (as the tests here do)."""
    default = inspect.signature(state_from_numpy).parameters["device"].default
    assert torch.device(default).type == "cuda"


def test_lattice_layout_matches_jax():
    """With the jitter off, the lattice is deterministic and exact."""
    import jax

    args = (1000, (0.025, 0.025, 0.025), (13, 7, 11), 0.05)
    j = jinit._lattice_block(jax.random.PRNGKey(0), *args, jitter=0.0)
    t = tinit._lattice_block(torch.Generator().manual_seed(0), *args,
                             jitter=0.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_splash_scene_matches_jax_layout():
    """Same config, same drop/pool split and velocities; pool rows differ
    from the JAX ones only by the lattice jitter (< 0.2 spacing per axis)."""
    jc, js = jscene("splash", **SPLASH)
    tc, ts = tscene("splash", device="cpu", **SPLASH)
    assert _tcfg(jc) == tc
    n_drop = int(tc.num_particles * 0.15)
    np.testing.assert_array_equal(ts.velocity.numpy(), np.asarray(js.velocity))
    np.testing.assert_array_equal(ts.mass.numpy(), np.asarray(js.mass))
    pool_t = ts.position[n_drop:].numpy()
    pool_j = np.asarray(js.position)[n_drop:]
    assert np.abs(pool_t - pool_j).max() <= 2 * 0.2 * 0.05 + 1e-6
    box = np.asarray(tc.box_max)
    assert (ts.position.numpy() >= 1e-4).all()
    assert (ts.position.numpy() <= box).all()


def test_cell_ids_match_jax():
    rng = np.random.default_rng(3)
    jc = jscene("splash", **SPLASH)[0]
    pos = rng.uniform(-1.0, 17.0, (2000, 3)).astype(np.float32)
    j = jgrid.linear_cell_id(jc, jgrid.cell_coords(jc, jnp.asarray(pos)))
    t = tgrid.linear_cell_id(_tcfg(jc), tgrid.cell_coords(_tcfg(jc),
                                                          torch.from_numpy(pos)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_inverse_order_and_unsort():
    rng = np.random.default_rng(4)
    order = torch.from_numpy(rng.permutation(500))
    inv = tgrid.inverse_order(order)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(jgrid.inverse_order(jnp.asarray(order.numpy()))))
    vals = torch.from_numpy(rng.normal(size=(500, 3)).astype(np.float32))
    (back,) = tgrid.unsort_stacked(inv, [vals[order]])
    np.testing.assert_array_equal(back.numpy(), vals.numpy())


@pytest.mark.parametrize("block", [128, 256])
def test_prepare_t_tables_equal_jax(block):
    """order, sorted frame and cell ids equal JAX's, and the bands are the
    masked rows of JAX's window tables."""
    jc, js = jscene("splash", pallas_block_t=block, **SPLASH)
    tc = _tcfg(jc)
    p_j = jpt.prepare_t(jc, js)
    p_t = sweeps_t.prepare_t(
        tc, state_from_numpy(js.to_numpy(), device="cpu"))
    np.testing.assert_array_equal(p_t.order.numpy(), np.asarray(p_j.order))
    np.testing.assert_array_equal(p_t.cid.numpy(),
                                  np.asarray(p_j.cid_f).astype(np.int32))
    jax_windows.assert_prepared(tc, p_t, p_j.ws, p_j.wc)
    np.testing.assert_array_equal(p_t.pos_s.numpy(), np.asarray(p_j.pos_s))
    np.testing.assert_array_equal(p_t.vel_s.numpy(), np.asarray(p_j.vel_s))
    np.testing.assert_array_equal(p_t.mass_s.numpy(), np.asarray(p_j.mass_s))
    assert np.asarray(p_j.wc).max() > 1, \
        "want a multi-chunk window in the test scene"


def test_derive_window_t_matches_jax():
    jc, js = jscene("splash", **SPLASH)
    ts = state_from_numpy(js.to_numpy(), device="cpu")
    assert (sweeps_t.derive_window_t(_tcfg(jc), ts)
            == jpt.derive_window_t(jc, js))


def _random_state(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(box)
    # half the particles start within a step of a wall, moving outward
    edge = rng.random(n) < 0.5
    pos[edge, 0] = rng.choice([1e-3, box[0] - 1e-3], edge.sum())
    vel = rng.normal(0.0, 3.0, (n, 3))
    vel[edge, 0] = np.where(pos[edge, 0] < 1.0, -30.0, 30.0)
    acc = rng.normal(0.0, 50.0, (n, 3))
    mass = rng.uniform(0.5, 2.0, n)
    return (pos.astype(np.float32), vel.astype(np.float32),
            acc.astype(np.float32), mass.astype(np.float32))


@pytest.mark.parametrize("scene_kw", [
    dict(boundary="reflect", second_kick="none", central_mass=0.0,
         damping=0.5, dt=1e-3),                  # splash-like
    dict(),                                      # reference disk: gravity kick
    dict(boundary="reflect", sim_scale=0.5),     # gravity kick + reflect
])
def test_kdk_integrate_matches_jax(scene_kw):
    from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg

    jc = JCfg(**scene_kw)
    tc = _tcfg(jc)
    pos, vel, acc, mass = _random_state(512, jc.box_max, 5)
    js = JState.from_arrays(pos, vel, mass)
    ts = TState.from_arrays(torch.from_numpy(pos), torch.from_numpy(vel),
                            torch.from_numpy(mass))
    jn, jt = jint.kdk_integrate(jc, js, jnp.asarray(acc))
    tn, tt = tint.kdk_integrate(tc, ts, torch.from_numpy(acc))
    if jc.boundary == "reflect":
        assert (np.asarray(jn.velocity)[:, 0] * vel[:, 0] < 0).any()
    np.testing.assert_allclose(tn.position.numpy(), np.asarray(jn.position),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tn.velocity.numpy(), np.asarray(jn.velocity),
                               rtol=1e-6, atol=1e-6)
    for a, b in [(tt.kinetic, jt.kinetic), (tt.potential, jt.potential),
                 (tt.angular_momentum, jt.angular_momentum)]:
        assert abs(float(a) - float(b)) <= 1e-6 * max(abs(float(b)), 1e-30)
    assert _rel(tt.l_vec.numpy(), jt.l_vec) <= 1e-6


def test_reflect_boundary_matches_jax():
    from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg

    jc = JCfg(boundary="reflect", damping=0.5)
    pos, vel, _, _ = _random_state(512, jc.box_max, 6)
    new = pos + vel * 0.01
    jp, jv = jint.reflect_boundary(jc, jnp.asarray(pos), jnp.asarray(new),
                                   jnp.asarray(vel))
    tp, tv = tint.reflect_boundary(_tcfg(jc), torch.from_numpy(pos),
                                   torch.from_numpy(new), torch.from_numpy(vel))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_energy_tally_zero_gm_keeps_nan_canary():
    """G*M == 0 skips the PE pass, but a NaN position still reaches PE."""
    tc = TCfg(central_mass=0.0)
    pos = torch.tensor([[1.0, 1.0, 1.0], [float("nan"), 1.0, 1.0]])
    vel = torch.ones(2, 3)
    mass = torch.ones(2)
    t = tint.energy_tally(tc, pos, vel, mass)
    assert not torch.isfinite(t.potential)
    assert torch.isfinite(t.kinetic)
    fin = tint.energy_tally(tc, pos[:1], vel[:1], mass[:1])
    assert float(fin.potential) == 0.0
    j = jint.energy_tally(
        jscene("splash", **SPLASH)[0].replace(central_mass=0.0),
        jnp.asarray(pos.numpy()), jnp.asarray(vel.numpy()),
        jnp.asarray(mass.numpy()))
    assert not np.isfinite(float(j.potential))


def test_angular_momentum_vec_matches_jax():
    from smoothed_particle_hydrodynamics_tpu.config import SphConfig as JCfg

    jc = JCfg()
    pos, vel, _, mass = _random_state(256, jc.box_max, 7)
    j = jint.angular_momentum_vec(jc, jnp.asarray(pos), jnp.asarray(vel),
                                  jnp.asarray(mass))
    t = tint.angular_momentum_vec(_tcfg(jc), torch.from_numpy(pos),
                                  torch.from_numpy(vel), torch.from_numpy(mass))
    assert _rel(t.numpy(), j) <= 1e-6
