"""The readers of the port's own spans and counter (``spans.py``): on
records made by hand, on a port without the trace module, and on a traced
CPU run of the tiny cell, where the stream metrics have nothing to read."""

import math
import sys

import pytest

import core
import spans
from conftest import make_tiny, run_tiny

NEW = ("driver.drift_read_ms_per_step", "binning.prepare_stream_ms",
       "sweeps.stream_ms_per_step", "integrate.stream_ms_per_step",
       "sweeps.rows_tested_per_pair")
STREAM = {"binning.prepare_stream_ms", "sweeps.stream_ms_per_step",
          "integrate.stream_ms_per_step"}


def _span(name, host_ms, stream):
    return {"name": name, "parent": None, "up": -1, "step": None,
            "host_ns": (10**18, 10**18 + int(host_ms * 1e6)),
            "stream_ms": stream}


def _record(taken):
    return {"particles": 1000, "profile": {"steps": 4, "neighbor_mean": 25.0},
            spans.KEY: taken}


def test_readers_on_a_record_made_by_hand():
    taken = {"spans": [_span("driver.drift_read", 0.5, (0.0, 0.1)),
                       _span("driver.drift_read", 1.5, (2.0, 2.25)),
                       _span("binning.prepare", 3.0, (0.5, 2.5)),
                       _span("binning.prepare", 3.0, (4.0, 5.0)),
                       _span("sweeps.sorted", 2.0, (1.0, 4.0)),
                       _span("sweeps.sorted", 2.0, (5.0, 6.0)),
                       _span("integrate.kdk", 1.0, (6.0, 6.5))],
             "counts": {"sweeps.rows_tested": {"total": 4.0e6, "times": 8}},
             "dropped": 0}
    rec = _record(taken)
    got = {n: core.reader(n)(rec) for n in NEW}
    assert got == pytest.approx({
        "driver.drift_read_ms_per_step": 0.5,     # 2 ms over 4 steps
        "binning.prepare_stream_ms": 1.5,         # a mean of 2 and 1
        "sweeps.stream_ms_per_step": 1.0,
        "integrate.stream_ms_per_step": 0.125,
        "sweeps.rows_tested_per_pair": 4.0e6 / (8 * 1000 * 25.0)})


def test_off_the_card_the_stream_metrics_read_nothing():
    taken = {"spans": [_span("binning.prepare", 3.0, None),
                       _span("sweeps.sorted", 2.0, None),
                       _span("integrate.kdk", 1.0, None),
                       _span("driver.drift_read", 0.4, None)],
             "counts": {}, "dropped": 0}
    rec = _record(taken)
    assert all(core.reader(n)(rec) is None for n in STREAM)
    assert core.reader("sweeps.rows_tested_per_pair")(rec) is None
    assert core.reader("driver.drift_read_ms_per_step")(rec) == \
        pytest.approx(0.1)


def test_a_port_without_the_trace_module_gives_none(monkeypatch):
    monkeypatch.setitem(
        sys.modules, "smoothed_particle_hydrodynamics_tpu_torch.utils.trace",
        None)   # an import of it raises ImportError
    rec = {"particles": 1000, "profile": {"steps": 4, "neighbor_mean": 25.0}}
    assert all(core.reader(n)(rec) is None for n in NEW)
    assert rec[spans.KEY] is None
    # nothing to read without a profiled solve
    assert all(core.reader(n)({"particles": 1}) is None for n in NEW)


def test_the_readers_on_a_traced_tiny_run(tmp_path):
    root, here = make_tiny(tmp_path, n=1500, steps=6, checked=2)
    res = run_tiny(root, here, trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    for name in NEW:
        if name in STREAM:
            assert name not in m, name     # no CUDA stream on the CPU
        else:
            assert math.isfinite(m[name]["value"]) and m[name]["value"] > 0
    assert m["sweeps.rows_tested_per_pair"]["unit"] == "rows/pair"
    # the rows a lane tests hold every pair within h and the row itself
    assert m["sweeps.rows_tested_per_pair"]["value"] > 1.0
    # the run took what the port recorded: the next run reads its own only
    from smoothed_particle_hydrodynamics_tpu_torch.utils import trace

    assert trace.take() == {"spans": [], "counts": {}, "dropped": 0}
