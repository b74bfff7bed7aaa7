"""The port's entry layer against the JAX package's: ``bench --lazy/--no-lazy``
and the benchmark record, and the package's top-level names.

``bench``: each flag value (none, ``--lazy``, ``--no-lazy``, and the port's
``--eager``, which is ``--no-lazy``) on the CPU's default backend and on
``--backend pallas`` (sublane and lane layouts) resolves the driver as the
JAX CLI's ``cmd_bench`` does (both commands' ``run_benchmark`` replaced by
a recorder); ``--lazy`` with the cell-list backend is ``run_benchmark``'s
ValueError; ``run_benchmark``'s record holds every key of the JAX
package's, with its ``metric``, ``unit`` and ``platform``.

The top-level names: JAX's ``__all__`` but ``make_step`` (a ``jax.jit``
wrapper), importable from the port's package, which builds no kernel on
import; ``simulate`` from it against JAX's ``simulate`` on a 2048-particle
disk (2 cell-list steps, in blocks of 1): neighbor counts equal, density
rel-L2 <= 1e-6, acceleration rel-L2 <= 1e-4, the one-step bars (after 4
steps the trajectories' f32 differences had grown to a density rel-L2 of
1.26e-6).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import smoothed_particle_hydrodynamics_tpu as jpkg
from smoothed_particle_hydrodynamics_tpu import cli as jcli
from smoothed_particle_hydrodynamics_tpu.utils import benchmark as jbench
import smoothed_particle_hydrodynamics_tpu_torch as tpkg
from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.utils import benchmark

torch.set_num_threads(1)

PKG = "smoothed_particle_hydrodynamics_tpu_torch"


def _recorder(monkeypatch, module) -> dict:
    seen = {}

    def record(**kwargs):
        seen.update(kwargs)
        return {}

    monkeypatch.setattr(module, "run_benchmark", record)
    return seen


FLAGS = {"none": [], "lazy": ["--lazy"], "no-lazy": ["--no-lazy"],
         "eager": ["--eager"]}
BACKENDS = {"auto": [], "pallas": ["--backend", "pallas"],
            "pallas-lane": ["--backend", "pallas", "--set",
                            "pallas_layout=lane"]}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("flag", FLAGS)
def test_bench_lazy_flag_resolves_as_the_jax_cli(flag, backend, monkeypatch):
    """The driver ``bench`` hands ``run_benchmark`` is the JAX CLI's for the
    same flags (``--eager`` against JAX's ``--no-lazy``)."""
    want = _recorder(monkeypatch, jbench)
    jflag = FLAGS["no-lazy" if flag == "eager" else flag]
    assert jcli.main(["bench", *jflag, *BACKENDS[backend]]) == 0
    got = _recorder(monkeypatch, benchmark)
    assert main(["bench", "--device", "cpu", *FLAGS[flag],
                 *BACKENDS[backend]]) == 0
    assert got["lazy"] is want["lazy"], (flag, backend, got, want)
    assert got["backend"] == want["backend"]


def test_bench_lazy_with_celllist_is_refused():
    """``--lazy`` with a backend that has no lazy driver: the JAX
    package's ValueError, from ``run_benchmark``."""
    for m, argv in ((jcli.main, []), (main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="lazy=True benchmarks the "
                                             "pallas backend"):
            m(["bench", "--lazy", "--backend", "celllist", "-n", "64",
               "--steps", "1", "--warmup", "1", *argv])


def test_run_benchmark_record_has_the_jax_keys():
    want = jbench.run_benchmark(scene="disk", steps=1, warmup=1,
                                overrides={"num_particles": 256})
    got = benchmark.run_benchmark(scene="disk", steps=1, warmup=1,
                                  overrides={"num_particles": 256},
                                  device="cpu")
    assert set(want) <= set(got), set(want) - set(got)
    for k in ("metric", "unit", "scene", "backend", "lazy", "num_particles",
              "steps"):
        assert got[k] == want[k], k
    assert got["metric"] == "particle-steps/sec/chip"
    assert got["unit"] == "particle-steps/s"
    assert got["platform"] == want["platform"] == "cpu"


def test_exports_are_the_jax_packages_but_make_step():
    want = set(jpkg.__all__) - {"make_step"}
    assert want <= set(tpkg.__all__), want - set(tpkg.__all__)
    for name in tpkg.__all__:
        assert hasattr(tpkg, name), name
    assert "make_step" not in tpkg.__all__
    assert tpkg.__version__ == jpkg.__version__
    # the five names the port exported before stay
    assert {"ParticleState", "SphConfig", "make_scene", "state_from_numpy",
            "state_to_numpy"} <= set(tpkg.__all__)


def test_import_builds_no_kernel(tmp_path):
    """Importing the package and its top-level names runs no nvcc and
    loads no built library (an audit hook sees every ``subprocess.Popen``
    and ``ctypes.dlopen``)."""
    code = (
        "import sys\n"
        "seen = []\n"
        "def hook(ev, args):\n"
        "    if ev == 'subprocess.Popen' or (ev == 'ctypes.dlopen' and args"
        " and '_build' in str(args[0])):\n"
        "        seen.append((ev, str(args)[:200]))\n"
        "sys.addaudithook(hook)\n"
        f"from {PKG} import (simulate, step, run_steps, compute_forces,\n"
        "    init_splash, init_dam_break, init_rotating_sphere, load_state,\n"
        "    StepDiagnostics, SphConfig, ParticleState, __version__)\n"
        f"import {PKG}.utils.build as b\n"
        "assert not seen, seen\n"
        "print('ok', __version__)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path),
                       env={**__import__("os").environ,
                            "PYTHONPATH": str(
                                __import__("pathlib").Path(__file__)
                                .resolve().parents[1])})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["ok", "0.1.0"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_top_level_simulate_matches_jax():
    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch import SphConfig, simulate

    jc, js = make_scene("disk", num_particles=2048)
    jc = jc.replace(total_time=jc.dt)     # num_steps 1: 2 steps
    ts = state_from_numpy(js.to_numpy(), device="cpu")  # JAX donates js
    jst, jd = jpkg.simulate(jc, js, steps_per_block=1)
    tst, td = simulate(SphConfig.from_json(jc.to_json()), ts,
                       steps_per_block=1)
    assert td.kinetic_energy.shape[0] == 2 == np.asarray(jd.kinetic_energy
                                                         ).shape[0]
    np.testing.assert_array_equal(tst.neighbor_count.numpy(),
                                  np.asarray(jst.neighbor_count))
    assert _rel(tst.density.numpy(), jst.density) <= 1e-6
    assert _rel(tst.acceleration.numpy(), jst.acceleration) <= 1e-4
    assert _rel(tst.position.numpy(), jst.position) <= 1e-6
