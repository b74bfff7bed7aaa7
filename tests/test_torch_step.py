"""The torch package's eager step (``ops/step.py``), scenes and CLI
backends against the JAX package.

One eager step per backend (the lane kernels' twins, the cell-list sweeps)
and a ``second_kick="full"`` step, each against the JAX ``step`` on the same
state: positions, velocities, densities and accelerations within rel 1e-5,
neighbor counts and every counter of the diagnostics equal.  A small
``cell_capacity`` makes ``overflow_cells`` nonzero on the backends that
report it; the sublane and lazy paths report 0, as in JAX.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smoothed_particle_hydrodynamics_tpu import init as jinit
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu.ops import step as jstep
from smoothed_particle_hydrodynamics_tpu_torch import init as tinit
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.models import SCENES
from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene as tscene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy as tlazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import step as tstep
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark as tbench

# The sweeps gain nothing from intra-op threads at these sizes, and under
# pytest-xdist eight torch threads per worker oversubscribe the cores.
torch.set_num_threads(1)

BAR = 1e-5
COUNTERS = ("neighbor_max", "neighbor_min", "overflow_cells",
            "truncated_ranges", "halo_dropped", "migration_dropped")
# packed dam break on 16^3 h-cells (~8 per cell): capacity 6 overflows
DAM = dict(num_particles=1024, grid_nx=16, grid_ny=16, grid_nz=16,
           pallas_window=128, cell_capacity=6)
# the disk at h = 0.5 on 8^3 2h-cells, central gravity on
DISK = dict(num_particles=1024, grid_nx=8, grid_ny=8, grid_nz=8, h=0.5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _scenes(scene, **kw):
    jc, js = jscene(scene, pallas_interpret=True, **kw)
    return (jc, js, TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device="cpu"))


def _same_step(jres, tres):
    (js, jd), (ts, td) = jres, tres
    for name in ("position", "velocity", "density", "acceleration"):
        assert _rel(getattr(ts, name).numpy(), getattr(js, name)) <= BAR, name
    np.testing.assert_array_equal(ts.neighbor_count.numpy(),
                                  np.asarray(js.neighbor_count))
    for name in COUNTERS:
        assert int(getattr(td, name)) == int(getattr(jd, name)), name
    for name in ("kinetic_energy", "potential_energy", "angular_momentum",
                 "neighbor_mean"):
        assert _rel(float(getattr(td, name)), float(getattr(jd, name))) <= BAR


@pytest.mark.parametrize("layout,backend", [("lane", "pallas"),
                                            ("sublane", "celllist")])
def test_eager_step_matches_jax(layout, backend):
    jc, js, tc, ts = _scenes("dam_break", pallas_layout=layout, **DAM)
    jres = jstep.step(jc, js, backend=backend)
    tres = tstep.step(tc, ts, backend=backend)
    _same_step(jres, tres)
    assert int(tres[1].overflow_cells) > 0


def test_full_second_kick_step_matches_jax():
    """The closing half kick re-evaluates the whole force at the drifted
    state; the new acceleration and density are the second evaluation's."""
    jc, js, tc, ts = _scenes("disk", second_kick="full", **DISK)
    jres = jstep.step(jc, js, backend="celllist")
    tres = tstep.step(tc, ts, backend="celllist")
    _same_step(jres, tres)
    first = tstep.compute_forces(tc, ts, backend="celllist")[0]
    assert _rel(tres[0].acceleration.numpy(), first.numpy()) > 1e-6


def test_overflow_cells_zero_on_sublane_and_lazy():
    """The sublane frame has no per-cell capacity: its eager and lazy steps
    report 0 where the cell-list step counts the overfull cells."""
    _, _, tc, ts = _scenes("dam_break", **dict(DAM, pallas_window_t=64))
    _, d_cl = tstep.step(tc, ts, backend="celllist")
    _, d_sub = tstep.step(tc, ts, backend="pallas")
    _, d_lazy = tlazy.drive_loop_lazy(tc, ts, 2)
    assert int(d_cl.overflow_cells) > 0
    assert int(d_sub.overflow_cells) == 0
    assert d_lazy.overflow_cells.tolist() == [0, 0]


def test_simulate_runs_num_steps_plus_one_in_blocks():
    _, _, tc, ts = _scenes("disk", **dict(DISK, num_particles=256))
    tc = tc.replace(total_time=5 * tc.dt)
    seen = []

    def callback(step, state, diags):
        seen.append((step, diags.kinetic_energy.shape[0]))

    final, diags = tstep.simulate(tc, ts, backend="celllist",
                                  steps_per_block=2, callback=callback)
    assert tc.num_steps == 5
    assert seen == [(0, 2), (2, 2), (4, 2)]
    assert diags.kinetic_energy.shape == (6,)
    ref, ref_diags = tstep.run_steps(tc, ts, 6, backend="celllist")
    np.testing.assert_array_equal(final.position.numpy(),
                                  ref.position.numpy())
    np.testing.assert_array_equal(diags.kinetic_energy.numpy(),
                                  ref_diags.kinetic_energy.numpy())


def test_disk_velocity_matches_jax():
    jc, _ = jscene("disk", num_particles=64)
    rng = np.random.default_rng(9)
    pos = (np.asarray(jc.central_pos)
           + rng.normal(0.0, 1.0, (2000, 3))).astype(np.float32)
    j = jinit.disk_velocity(jc, jnp.asarray(pos))
    t = tinit.disk_velocity(TCfg.from_json(jc.to_json()), torch.from_numpy(pos))
    assert _rel(t.numpy(), j) <= 1e-6
    assert (t[:, 1] == 0).all()


def test_entry_points_default_to_the_card():
    """Every scene factory and initial-condition builder defaults to the
    card (no tensor is made here)."""
    fns = list(SCENES.values()) + [tinit.init_splash, tinit.init_dam_break,
                                   tinit.init_rotating_sphere]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert inspect.signature(tbench.run_parity_check).parameters[
        "device"].default == "cuda"


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_configs_and_layout_match_jax(scene):
    """The same config as the JAX scene, the JAX seed, and an initial state
    of the same kind (states differ only by the random draws)."""
    n = 1000
    jc, js = jscene(scene, num_particles=n)
    tc, ts = tscene(scene, num_particles=n, device="cpu")
    assert TCfg.from_json(jc.to_json()) == tc
    default_seed = inspect.signature(SCENES[scene]).parameters["seed"].default
    assert default_seed == {"disk": 42, "honey": 42, "splash": 11}.get(scene, 7)
    pos = ts.position.numpy()
    assert pos.shape == (n, 3) and ts.mass.shape == (n,)
    assert (pos >= 0).all() and (pos <= np.asarray(tc.box_max)).all()
    np.testing.assert_array_equal(ts.mass.numpy(), np.asarray(js.mass))
    if scene in ("disk", "honey"):
        r = np.linalg.norm(pos - np.asarray(tc.central_pos), axis=1)
        assert r.max() <= 2.0 + 1e-5
        v = ts.velocity.numpy()
        np.testing.assert_allclose(
            v[:, [0, 2]], tinit.disk_velocity(tc, ts.position).numpy()[:, [0, 2]],
            rtol=1e-6)
        assert np.abs(v[:, 1]).max() <= 0.25
    if scene.startswith("dam_break"):
        # the same lattice as JAX, up to the jitter (< 0.2 spacing per axis)
        assert (ts.velocity == 0).all()
        assert np.abs(pos - np.asarray(js.position)).max() <= 0.4 * 0.05 + 1e-6


def test_disk_exact_ic_and_dam_break_overflow_raise():
    with pytest.raises(ValueError, match="compat"):
        tscene("disk", num_particles=64, device="cpu", exact_ic=True)
    with pytest.raises(ValueError, match="overflow the box"):
        jscene("dam_break", num_particles=100_000, grid_nx=8, grid_ny=8,
               grid_nz=8)
    with pytest.raises(ValueError, match="overflow the box"):
        tscene("dam_break", num_particles=100_000, grid_nx=8, grid_ny=8,
               grid_nz=8, device="cpu")


def test_compute_forces_rejects_compat_and_unknown_backends():
    _, _, tc, ts = _scenes("disk", **dict(DISK, num_particles=128))
    with pytest.raises(NotImplementedError, match="compat"):
        tstep.compute_forces(tc, ts, backend="compat")
    with pytest.raises(NotImplementedError, match="compat"):
        tstep.step(tc.replace(compat=True), ts, backend="celllist")
    with pytest.raises(ValueError, match="unknown backend"):
        tstep.compute_forces(tc, ts, backend="xla")
    with pytest.raises(ValueError, match="pallas_layout"):
        tstep.compute_forces(tc.replace(pallas_layout="tiled"), ts,
                             backend="pallas")


def test_run_benchmark_eager_backends_on_cpu():
    ov = dict(num_particles=512, grid_nx=8, grid_ny=8, grid_nz=8, h=0.5)
    with pytest.raises(ValueError, match="pallas backend"):
        tbench.run_benchmark(scene="disk", lazy=True, backend="celllist",
                             device="cpu", overrides=ov)
    for backend, layout in (("celllist", "sublane"), ("pallas", "lane")):
        r = tbench.run_benchmark(scene="disk", lazy=False, backend=backend,
                                 steps=2, warmup=1, device="cpu",
                                 overrides=dict(ov, pallas_layout=layout))
        assert (r["backend"], r["pallas_layout"], r["lazy"]) == (
            backend, layout, False)
        assert r["finite"] and r["truncated_ranges"] == [0, 0, 0]
        assert r["overflow_cells"] == [0, 0, 0] and r["device"] == "cpu"


def test_cli_backend_choice(capsys, tmp_path):
    """auto is celllist on the CPU (eager); pallas in the sublane layout
    drives the lazy loop; the lane layout and the other backends run the
    eager loop; range_slice=0 is derived."""
    import json

    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main

    base = ["-n", "512", "--steps", "2", "--device", "cpu", "--scene", "disk",
            "--set", "grid_nx=8", "--set", "grid_ny=8", "--set", "grid_nz=8",
            "--set", "h=0.5"]
    for extra, want in [
            ([], ("celllist", False)),
            (["--backend", "pallas"], ("pallas", True)),
            (["--backend", "pallas", "--set", "pallas_layout=lane"],
             ("pallas", False)),
            (["--backend", "pairwise"], ("pairwise", False)),
            (["--backend", "celllist", "--set", "range_slice=0"],
             ("celllist", False))]:
        out = str(tmp_path / "o")
        assert main(["run", "--block", "2", "--out", out] + base + extra) == 0
        capsys.readouterr()
        meta = json.load(open(f"{out}/run.json"))
        assert (meta["backend"], meta["lazy"]) == want, extra
        with open(f"{out}/diagnostics.jsonl") as fh:
            last = json.loads(fh.readlines()[-1])
        assert last["step"] == 1 and np.isfinite(last["kinetic_energy"])
        assert main(["bench", "--warmup", "1"] + base + extra) == 0
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert (rec["backend"], rec["lazy"]) == want, extra
