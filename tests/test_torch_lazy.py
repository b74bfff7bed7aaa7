"""The torch package's step loops: the lazy step against the JAX one, lazy
against eager, the eager sweep step against the pairwise step, the
benchmark and the CLI.

``test_lazy_steps_match_jax_interpret``: six steps of the 768-particle
splash at 1.25h cells from one state, the JAX ``lazy_step`` (Pallas kernels
in interpreter mode) against the torch ``lazy_step`` (the kernels' plain
twins on CPU).  Both must rebin on the same steps, sort identically, count
the same neighbors every step and agree on positions, velocities and
kinetic energy to rel 1e-5.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import lazy as jlazy
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy

STEPS = 6
BAR = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(**kw):
    base = dict(num_particles=768, cell_size_factor=1.25, pallas_window_t=64,
                pallas_interpret=True)
    base.update(kw)
    jc, js = jscene("splash", **base)
    return jc, js, TCfg.from_json(jc.to_json()), state_from_numpy(js.to_numpy())


def test_lazy_steps_match_jax_interpret():
    jc, js, tc, ts = _scenes()
    jcarry = jax.jit(partial(jlazy.init_lazy, jc))(js)
    jstep = jax.jit(partial(jlazy.lazy_step, jc))
    tcarry = tlazy.init_lazy(tc, ts)
    rebins = []
    for k in range(STEPS):
        jcarry, jd = jstep(jcarry)
        tcarry, td = tlazy.lazy_step(tc, tcarry)
        assert tcarry.rebin_count == int(jcarry.rebin_count), f"step {k}"
        assert tcarry.steps_since == int(jcarry.steps_since), f"step {k}"
        rebins.append(tcarry.rebin_count)
        np.testing.assert_array_equal(tcarry.order.numpy(),
                                      np.asarray(jcarry.order))
        np.testing.assert_array_equal(tcarry.ws.numpy(), np.asarray(jcarry.ws))
        np.testing.assert_array_equal(tcarry.wc.numpy(), np.asarray(jcarry.wc))
        np.testing.assert_array_equal(tcarry.state.neighbor_count.numpy(),
                                      np.asarray(jcarry.state.neighbor_count))
        assert _rel(tcarry.state.position.numpy(),
                    jcarry.state.position) <= BAR, f"step {k}"
        assert _rel(tcarry.state.velocity.numpy(),
                    jcarry.state.velocity) <= BAR, f"step {k}"
        assert _rel(float(td.kinetic_energy), float(jd.kinetic_energy)) <= BAR
        assert int(td.neighbor_max) == int(jd.neighbor_max)
        assert int(td.neighbor_min) == int(jd.neighbor_min)
    assert rebins[-1] >= 1, "no rebin in the run"
    assert rebins[0] == 0, "no step on frozen bins"


def test_lazy_matches_eager_step():
    """Frozen bins between rebins give the same physics as rebinning every
    step (ops.step), in the caller's particle order."""
    _, _, tc, ts = _scenes(cell_size_factor=1.5)
    got, diags = tlazy.drive_loop_lazy(tc, ts, STEPS)
    ref, ref_diags = tstep.drive_loop(tc, ts, STEPS)
    np.testing.assert_allclose(got.position.numpy(), ref.position.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.density.numpy(), ref.density.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.neighbor_count.numpy(),
                                  ref.neighbor_count.numpy())
    np.testing.assert_allclose(diags.kinetic_energy.numpy(),
                               ref_diags.kinetic_energy.numpy(), rtol=1e-5)


def test_forced_rebin_on_drift():
    _, _, tc, ts = _scenes(cell_size_factor=1.5)
    carry = tlazy.init_lazy(tc, ts)
    carry, _ = tlazy.lazy_step(tc, carry)
    base = carry.rebin_count
    kick = torch.zeros_like(carry.state.position)
    kick[0, 0] = tlazy.skin_half(tc) * 2.5
    carry = carry._replace(state=carry.state._replace(
        position=carry.state.position + kick))
    carry, _ = tlazy.lazy_step(tc, carry)
    assert carry.rebin_count == base + 1 and carry.steps_since == 0


def test_unsort_carry_round_trip():
    _, _, tc, ts = _scenes()
    ts = ts._replace(mass=torch.arange(1, ts.n + 1, dtype=torch.float32))
    got, _ = tlazy.drive_loop_lazy(tc, ts, 3, collect_diags=False)
    np.testing.assert_array_equal(got.mass.numpy(), ts.mass.numpy())


def test_validate_rejects_full_second_kick():
    _, _, tc, ts = _scenes(second_kick="full")
    with pytest.raises(ValueError):
        tlazy.init_lazy(tc, ts)


def test_eager_pallas_step_matches_pairwise_step():
    """ops.step with the sweep backend against the O(N^2) backend."""
    _, _, tc, ts = _scenes(num_particles=512)
    a, da = tstep.drive_loop(tc, ts, 2, backend="pallas")
    b, db = tstep.drive_loop(tc, ts, 2, backend="pairwise")
    np.testing.assert_array_equal(a.neighbor_count.numpy(),
                                  b.neighbor_count.numpy())
    assert _rel(a.velocity.numpy(), b.velocity.numpy()) <= BAR
    assert _rel(da.kinetic_energy.numpy(), db.kinetic_energy.numpy()) <= BAR
    assert int(da.truncated_ranges.sum()) == 0


@pytest.mark.parametrize("lazy", [True, False])
def test_run_benchmark_on_cpu(lazy):
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        run_benchmark)

    r = run_benchmark(lazy=lazy, steps=2, warmup=1, device="cpu",
                      overrides=dict(num_particles=512, cell_size_factor=1.25,
                                     pallas_window_t=0))
    assert r["device"] == "cpu" and r["finite"] and r["steps"] == 2
    assert r["window_t"] % 8 == 0 and r["window_t"] >= 64
    assert len(r["kinetic_energy"]) == 2


def test_cli_run_prints_one_line_per_block(capsys):
    import json

    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main

    assert main(["run", "-n", "384", "--steps", "3", "--block", "2",
                 "--device", "cpu", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [2, 3]
    assert all(np.isfinite(x["kinetic_energy"]) for x in lines)
    assert all(x["neighbor_max"] >= x["neighbor_min"] for x in lines)
