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

# The twins gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores (on an
# 8-core host the torch test files took 682 s with them, 55 s with one).
torch.set_num_threads(1)

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
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


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
    ref, ref_diags = tstep.drive_loop(tc, ts, STEPS, backend="pallas")
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


@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
def test_bin_from_is_the_frame_the_bins_sorted(capped):
    """``LazyCarry.bin_from``: None after ``init_lazy`` (the caller's own
    order) and in exact mode; in capped mode, after a forced rebin, the
    previous carry's ``order`` itself (no copy), kept while the bins are
    frozen."""
    kw = dict(capped_candidates=4, pallas_window_t=128) if capped else {}
    _, _, tc, ts = _scenes(**kw)
    carry = tlazy.init_lazy(tc, ts)
    assert carry.bin_from is None
    kick = torch.zeros_like(carry.state.position)
    kick[0, 0] = tlazy.skin_half(tc) * 2.5
    prev = carry._replace(state=carry.state._replace(
        position=carry.state.position + kick))
    carry, _ = tlazy.lazy_step(tc, prev)
    assert carry.rebin_count == 1 and carry.steps_since == 0
    if not capped:
        assert carry.bin_from is None
        return
    assert carry.bin_from is prev.order
    assert not torch.equal(carry.order, prev.order)
    frozen = carry._replace(pos_bin=carry.state.position)
    after, _ = tlazy.lazy_step(tc, frozen)
    assert after.steps_since == 1 and after.bin_from is prev.order


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

    r = run_benchmark(scene="splash", lazy=lazy, steps=2, warmup=1,
                      device="cpu", backend="pallas",
                      overrides=dict(num_particles=512, cell_size_factor=1.25,
                                     pallas_window_t=0))
    assert r["device"] == "cpu" and r["finite"] and r["steps"] == 2
    assert r["window_t"] % 8 == 0 and r["window_t"] >= 64
    assert len(r["kinetic_energy"]) == 2


def test_cli_run_prints_one_line_per_block(capsys, tmp_path):
    """One ``step k/total`` line per block; every step's diagnostics in
    ``diagnostics.jsonl``."""
    import json

    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main

    out = str(tmp_path / "o")
    assert main(["run", "--scene", "splash", "-n", "384", "--steps", "3",
                 "--block", "2", "--out", out,
                 "--device", "cpu", "--set", "cell_size_factor=1.25",
                 "--set", "pallas_window_t=64"]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("step ")]
    assert [x.split()[1] for x in lines] == ["2/3", "3/3"]
    rows = [json.loads(x) for x in open(f"{out}/diagnostics.jsonl")]
    assert [x["step"] for x in rows] == [0, 1, 2]
    assert all(np.isfinite(x["kinetic_energy"]) for x in rows)
    assert all(x["neighbor_max"] >= x["neighbor_min"] for x in rows)


def test_cli_refuses_to_fall_back_to_cpu(monkeypatch):
    """--device defaults to cuda; with no CUDA device the run stops with an
    error instead of carrying on on the CPU."""
    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("run", "bench"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([cmd, "--scene", "splash", "-n", "384", "--steps", "1"])


def test_pairwise_backend_rejects_capped_config():
    _, _, tc, ts = _scenes(num_particles=256)
    with pytest.raises(ValueError, match="capped_candidates"):
        tstep.compute_forces(tc.replace(capped_candidates=4), ts,
                             backend="pairwise")


def test_cli_run_resolves_capped_settings(tmp_path):
    """run and bench resolve capped mode's block (256), the derived window
    and the derived sub-frame length through one function."""
    import json

    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_sweep_settings, run_benchmark)

    ov = dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16,
              cell_size_factor=1.25, capped_candidates=4, pallas_window_t=0)
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene

    want = resolve_sweep_settings(
        *make_scene("splash", device="cpu", seed=11, **ov), ov)
    assert want.pallas_block_t == 256 and want.pallas_window_t >= 64
    assert 0 < want.capped_sub_len < 1024
    out = str(tmp_path / "o")
    assert main(["run", "--scene", "splash", "-n", "1024", "--steps", "2",
                 "--block", "2", "--out", out,
                 "--device", "cpu", "--backend", "pallas"]
                + [f"--set={k}={v}" for k, v in ov.items()
                   if k != "num_particles"]) == 0
    got = json.load(open(f"{out}/run.json"))["config"]
    assert (got["pallas_block_t"], got["pallas_window_t"],
            got["capped_sub_len"]) == (
        want.pallas_block_t, want.pallas_window_t, want.capped_sub_len)
    rows = [json.loads(x) for x in open(f"{out}/diagnostics.jsonl")]
    assert len(rows) == 2
    assert all(x["truncated_ranges"] == 0 and np.isfinite(x["kinetic_energy"])
               for x in rows)
    r = run_benchmark(scene="splash", lazy=True, steps=1, warmup=1,
                      device="cpu", overrides=ov, backend="pallas")
    assert (r["block_t"], r["window_t"], r["capped_sub_len"]) == (
        want.pallas_block_t, want.pallas_window_t, want.capped_sub_len)
    assert r["truncated_ranges"] == [0, 0] and r["finite"]
