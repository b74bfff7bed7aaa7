"""The command itself: nothing of JAX is loaded, no result without a card,
and on a card one short run of the 1M cell."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import run
from conftest import TINY

RUN = Path(run.__file__)


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole traced CPU run of the tiny cell in a fresh process, then the
    top-level names in its ``sys.modules``."""
    code = f"""
import sys, time, json, torch
sys.path[:0] = [{str(RUN.parent)!r}, {str(RUN.parent / 'tests')!r}]
from conftest import make_tiny, run_tiny
from pathlib import Path
import run
root, here = make_tiny(Path({str(tmp_path)!r}), n=1500, steps=6, checked=2)
res = run_tiny(root, here, trace=True)
print(json.dumps([res["correct"], run.forbidden_loaded(),
                  sorted({{m.split('.')[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, forbidden, top = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and forbidden == []
    assert "smoothed_particle_hydrodynamics_tpu_torch" in top
    assert not {"jax", "jaxlib", "flax",
                "smoothed_particle_hydrodynamics_tpu"} & set(top)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "smoothed_particle_hydrodynamics_tpu_x",
                        sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "smoothed_particle_hydrodynamics_tpu.ops",
                        sys)
    assert "smoothed_particle_hydrodynamics_tpu" in run.forbidden_loaded()


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, str(RUN), "--workload", "splash_1m_exact.solve",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.card
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, str(RUN), "--workload", "splash_1m_exact.solve",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"particle_steps_per_s",
                                   "block_step_ms_p95", "setup_s"}
    assert TINY not in out.stdout
