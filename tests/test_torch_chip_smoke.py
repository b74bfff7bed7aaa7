"""``chip_smoke.py`` leaves no process of its own running when it ends.

Its slab phases start ranks through ``spawn_ranks`` with the ``spawn``
method, which starts multiprocessing's resource tracker as a child of the
script.  ``chip_smoke.stop_resource_tracker`` (run on every exit) must stop
and reap it.  On the CPU, with gloo ranks, in a subprocess so that this
test process's own tracker is left alone.  ``utils/leftover.py``, which
reports the processes that outlive a command, and the script's run without
a card under it.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import operator
import os

from multiprocessing import resource_tracker

import chip_smoke
from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import spawn_ranks

assert spawn_ranks(2, operator.truth, backend="gloo",
                   timeout_s=120) == [True, True]
pid = resource_tracker._resource_tracker._pid
os.kill(pid, 0)   # the tracker outlived the ranks
chip_smoke.stop_resource_tracker()
try:
    os.kill(pid, 0)
except ProcessLookupError:
    print("reaped", pid)
else:
    print("running", pid)
"""


def test_stop_resource_tracker_reaps_the_spawned_ranks_tracker():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("reaped "), out.stdout
    assert "leaked" not in out.stderr, out.stderr


def leftover(*cmd: str) -> tuple[int, dict]:
    out = subprocess.run(
        [sys.executable, "-m",
         "smoothed_particle_hydrodynamics_tpu_torch.utils.leftover", "--",
         *cmd], cwd=ROOT, capture_output=True, text=True, timeout=240)
    return out.returncode, json.loads(out.stdout.splitlines()[-1])


def test_leftover_reports_a_process_that_outlives_its_command():
    rc, rep = leftover("sh", "-c", "sleep 1 & exit 0")
    left = rep["after_exit"][0]["left"]
    assert rc == 1 and rep["rc"] == 0
    assert [line for _, _, line in left.values()] == ["sleep 1"]
    assert not rep["after_exit"][-1]["left"]


def test_leftover_passes_a_command_that_leaves_nothing():
    rc, rep = leftover("sh", "-c", "sleep 0.3; exit 3")
    assert rc == 3 and rep["rc"] == 3
    assert rep["after_exit"] == [{"t": 0.0, "left": {}}]
    assert "sleep 0.3" in rep["seen"].values()


def test_chip_smoke_without_cuda_exits_1_and_leaves_nothing():
    rc, rep = leftover(sys.executable, "chip_smoke.py")
    assert rc == 1 and rep["rc"] == 1
    assert rep["after_exit"] == [{"t": 0.0, "left": {}}]
