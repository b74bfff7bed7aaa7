"""CPU tests of the benchmark harness at tiny sizes (the port's kernels run
as their plain twins on the CPU).  ``tiny_bench`` copies the harness into a
temporary checkout with one tiny cell of its own; a test marked ``card``
runs only where a CUDA card is present, and decides so inside the test."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = "tiny.splash"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test without one")


def make_tiny(root: Path, n: int = 3000, steps: int = 30, block: int = 3,
              checked: int = 10, **sph) -> tuple[Path, Path]:
    """A checkout under ``root`` holding the harness, BENCHMARK.json and
    one tiny cell: the 1M splash's settings, with ``sph``'s on top, at
    ``n`` particles on a 16^3 grid, the drop released just over the pool
    so that it strikes it within the solve, ``steps`` steps a solve in
    blocks of ``block``, ``checked`` checked steps in its first solve."""
    here = root / "bench_port"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    config = json.loads((HERE / "configs" / "splash_1m_exact.json")
                        .read_text())
    config["sph"].update(num_particles=n, grid_nx=16, grid_ny=16, grid_nz=16,
                         total_time=steps * config["sph"]["dt"], **sph)
    config["initial"]["drop_height"] = 0.2
    (here / "configs" / "tiny.json").write_text(json.dumps(config))
    (here / "traffic" / "tiny.json").write_text(json.dumps(
        {"why": "tests", "block": block,
         "checked_steps": checked, "checked_solves": 1}))
    shutil.copy(HERE / "limits" / "splash_1m_exact.json",
                here / "limits" / "tiny.json")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="bench_port/configs/tiny.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name=TINY,
                                   config="tiny", traffic="tiny"))
    for m in bench["per_layer"]:
        m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, here


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny(tmp_path)


def run_tiny(root: Path, here: Path, seed: int = 5, trace: bool = False,
             seconds: float = 0.0) -> dict:
    """One CPU run of the tiny cell through the harness; its result."""
    import time

    import torch

    import core
    import run

    bench = core.load_bench(root)
    return run.run_cell(bench, TINY, seed, seconds, trace,
                        torch.device("cpu"), time.perf_counter(), root=root,
                        here=here)["result"]
