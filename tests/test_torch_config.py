"""The torch package's config against the JAX SphConfig, and its JAX-free
imports."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from smoothed_particle_hydrodynamics_tpu import config as jcfg
from smoothed_particle_hydrodynamics_tpu_torch import config as tcfg

REPO = Path(__file__).resolve().parents[1]
PKG = "smoothed_particle_hydrodynamics_tpu_torch"
DERIVED = ["h2", "cell_size", "inv_cell_size", "h_scaled", "h_scaled2",
           "h_scaled6", "h_scaled9", "box_max", "central_pos", "softening_eff",
           "num_cells", "num_steps", "poly6_norm", "spiky_grad_norm",
           "visc_lap_norm"]
CASES = [
    {},                                                   # reference disk
    dict(cell_size_factor=1.25, grid_nx=128, grid_ny=128, grid_nz=128,
         central_mass=0.0, include_self_density=True),    # bench splash
    dict(h=0.0371, sim_scale=0.004, softening=0.02, dt=2.5e-4),
]


def test_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(tcfg.SphConfig)]
            == [f.name for f in dataclasses.fields(jcfg.SphConfig)])
    assert (dataclasses.asdict(tcfg.SphConfig())
            == dataclasses.asdict(jcfg.SphConfig()))


@pytest.mark.parametrize("kw", CASES)
def test_derived_constants_bit_equal(kw):
    t, j = tcfg.SphConfig(**kw), jcfg.SphConfig(**kw)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("kw", [dict(cell_size_factor=0.5),
                                dict(capped_sub_len=100),
                                dict(num_particles=0)])
def test_validate_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jcfg.SphConfig(**kw).validate()
    with pytest.raises(ValueError):
        tcfg.SphConfig(**kw).validate()


def test_json_round_trip_across_packages():
    c = jcfg.SphConfig(cell_size_factor=1.25, gravity=(0.0, -9.81, 0.0))
    assert tcfg.SphConfig.from_json(c.to_json()) == tcfg.SphConfig(
        cell_size_factor=1.25, gravity=(0.0, -9.81, 0.0))


def test_package_imports_no_jax():
    """Import every module of the torch package in a fresh interpreter:
    none may pull in jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PKG} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_sources_name_no_jax():
    paths = sorted((REPO / PKG).rglob("*.py"))
    assert REPO / PKG / "ops" / "sweeps_t.py" in paths
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith(("import jax", "from jax"))), (path, s)
