"""The torch package's examples (``smoothed_particle_hydrodynamics_tpu_torch/
examples/``) run as a user runs them, and print the JAX examples' lines.

Each runs as a subprocess (a fresh interpreter) under
``SPH_EXAMPLE_QUICK=1`` with ``--device cpu``, in a scratch working
directory; the JAX package's ``examples/quickstart.py``,
``custom_scene.py`` and ``distributed.py`` (8 gloo ranks against an
8-device virtual mesh) run the same way on the CPU platform.  The two draw
their particles from different generators, so their numbers differ; the
lines are compared with every number (and the device name) blanked.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "custom_scene", "distributed")


def _env() -> dict:
    env = dict(os.environ, SPH_EXAMPLE_QUICK="1", JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _port(name: str, cwd: Path) -> str:
    proc = subprocess.run(
        [sys.executable, "-m",
         f"smoothed_particle_hydrodynamics_tpu_torch.examples.{name}",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _jax(name: str, cwd: Path) -> str:
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax, runpy; jax.config.update('jax_platforms', 'cpu'); "
         f"runpy.run_path({str(REPO / 'examples' / (name + '.py'))!r}, "
         "run_name='__main__')"],
        capture_output=True, text=True, timeout=300, cwd=cwd, env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _shape(text: str) -> list[str]:
    # the port's distributed example also prints where its ranks run
    lines = [re.sub(r"device=\S+", "device=?", ln) for ln in
             text.splitlines() if not ln.startswith("placement: ")]
    return [re.sub(r"[-+]?\d[\d.]*(e[-+]?\d+)?%?", "#", ln) for ln in lines]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_and_prints_the_jax_lines(name, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    out = _port(name, tmp_path / "t")
    assert _shape(out) == _shape(_jax(name, tmp_path / "j"))
    if name == "quickstart":
        assert "total-energy drift" in out
        assert "scene=disk n=2048 steps=10 device=cpu" in out
        png = (tmp_path / "t" / "quickstart_final.png").read_bytes()
        assert png.startswith(b"\x89PNG")
    elif name == "distributed":
        assert "placement: devices=[" + ", ".join(["cpu"] * 8) + "] comm=gloo" in out
        assert "devices=8  n=4096" in out
        assert "all particles accounted for" in out
    else:
        assert "final KE" in out and "step   0:" in out


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_stops_without_a_card(name, tmp_path):
    """The card is the default: without CUDA the example stops with an
    error instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m",
         f"smoothed_particle_hydrodynamics_tpu_torch.examples.{name}"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env=_env())
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert not list(tmp_path.iterdir())
