"""The capped full-run tool (``tools/capped_fullrun.py`` of the port) against
the JAX package's, and the port's committed full-run record.

``run_pair`` on the 2048-particle disk (2h cells) for 8 steps in both
packages from the same state (the JAX scene's, handed to the port): the
same-state density ratio at t = 0 within 1e-6, ``finite`` and
``cap_binds`` equal, the KE tail ratio within 1e-3 relative.  The JAX side
runs its kernels in interpreter mode (~100 s); the port its kernels' plain
twins.

``docs/capped_fullrun_torch.json``, the port's full-duration record from
the card, held to the envelopes ``tests/test_capped.py`` holds the JAX
package's TPU record to, unchanged, with its steps at full duration and an
NVIDIA card named in ``device``.  It does not skip: the record is part of
the repository.
"""

import importlib.util
import json
import os

import pytest
import torch

from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene
from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig as TCfg
from smoothed_particle_hydrodynamics_tpu_torch.state import state_from_numpy
from smoothed_particle_hydrodynamics_tpu_torch.tools import capped_fullrun

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    """A JAX tool module, loaded by its path (``tools/`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_scene_in_port(name, device="cpu", **kw):
    """``make_scene`` for the port's tools: the JAX scene (its generator,
    interpreter mode), its config and state handed over as the port's."""
    jc, js = jscene(name, pallas_interpret=True, **kw)
    return (TCfg.from_json(jc.to_json()),
            state_from_numpy(js.to_numpy(), device=device))


def test_run_pair_matches_jax(monkeypatch):
    kw = dict(num_particles=2048, cell_size_factor=2.0)
    want = jax_tool("capped_fullrun").run_pair("disk", 8, 50,
                                               pallas_interpret=True, **kw)
    monkeypatch.setattr(capped_fullrun, "make_scene", jax_scene_in_port)
    got = capped_fullrun.run_pair("disk", 8, 50, device="cpu", **kw)
    assert got["steps"] == want["steps"] == 8
    assert abs(got["density_ratio_t0"] - want["density_ratio_t0"]) <= 1e-6
    assert got["cap_binds"] == want["cap_binds"]
    for run in ("exact", "capped_k4"):
        assert got[run]["finite"] == want[run]["finite"] is True
    assert (abs(got["ke_tail_ratio"] - want["ke_tail_ratio"])
            <= 1e-3 * abs(want["ke_tail_ratio"]))
    assert got["scan_block"] == 50


def test_smoke_runs_are_marked(tmp_path):
    """``-n`` or a step scale below 1 marks the record a smoke run, and
    the record is written as each row completes."""
    out = str(tmp_path / "r.json")
    assert capped_fullrun.cli(["-n", "512", "--steps-scale", "0.004",
                               "--rows", "disk_32k", "--out", out,
                               "--device", "cpu"]) == 0
    rec = json.load(open(out))
    assert rec["smoke"] is True and rec["num_particles"] == 512
    assert rec["rows"]["disk_32k"]["steps"] == 4
    assert rec["device"].startswith("cpu")


def test_committed_record_passes_the_jax_records_envelopes():
    """The JAX record's test (``tests/test_capped.py``, its full-run
    record's envelopes), unchanged, on the port's card record."""
    path = os.path.join(REPO, "docs", "capped_fullrun_torch.json")
    art = json.load(open(path))
    assert art["steps_scale"] >= 1.0 and not art["smoke"], "a smoke run"
    assert "NVIDIA" in art["device"], art["device"]
    env = {
        "disk_32k": {"ke": (0.70, 1.45), "drift_abs": 0.75},
        "splash_1m": {"ke": (0.85, 1.20), "drift_abs": None},
    }
    for name, row in art["rows"].items():
        e = env[name]
        assert row["exact"]["finite"] and row["capped_k4"]["finite"], name
        assert 0.97 < row["density_ratio_t0"] < 1.03, (name, row)
        assert 0.97 < row["density_ratio_end"] < 1.03, (name, row)
        assert row["cap_binds"], name
        assert e["ke"][0] < row["ke_tail_ratio"] < e["ke"][1], (name, row)
        if e["drift_abs"] is not None:
            assert row["capped_k4"]["energy_drift"] < e["drift_abs"], (name,
                                                                      row)
        else:
            assert (row["capped_k4"]["energy_drift"]
                    < 1.5 * row["exact"]["energy_drift"] + 0.10), (name, row)
    assert "disk_32k" in art["rows"]
    assert art["rows"]["disk_32k"]["steps"] >= 1001
    assert art["rows"]["splash_1m"]["steps"] >= 1000
    # the tool's own check (chip_smoke.py phase 19) agrees
    assert capped_fullrun.envelope_failures(art["rows"]) == []


@pytest.mark.parametrize("row", list(capped_fullrun.ROWS))
def test_rows_are_the_jax_tools(row):
    """The same rows: steps, scan_block, scene and overrides."""
    jt = jax_tool("capped_fullrun")
    seen = {}
    jt.run_pair = lambda scene, steps, scan_block, **kw: seen.update(
        scene=scene, steps=steps, scan_block=scan_block, kw=kw)
    jt.ROWS[row](1.0)
    steps, scan_block, kw = capped_fullrun.ROWS[row]
    assert (capped_fullrun.SCENES[row], steps, scan_block, kw) == (
        seen["scene"], seen["steps"], seen["scan_block"], seen["kw"])
