"""The capped cell's readers (``binning.capped_sub_stream_ms``,
``sweeps.capped_gather_stream_ms_per_step``, ``sweeps.capped_roofline_pct``)
and ``work_capped.sweeps_bound``: on records made by hand, on a record with
none of the capped spans or the counter (a port that opens none, or an
exact cell), and on a traced CPU run of a tiny capped cell, where the
stream and device metrics have nothing to read."""

import pytest

import core
import spans
import work
import work_capped
from conftest import make_tiny, run_tiny

NEW = ("binning.capped_sub_stream_ms",
       "sweeps.capped_gather_stream_ms_per_step",
       "sweeps.capped_roofline_pct")


def _span(name, stream):
    return {"name": name, "parent": None, "up": -1, "step": None,
            "host_ns": (10**18, 10**18 + 1000), "stream_ms": stream}


def _record(taken, device_s=None):
    rec = {"particles": 1000,
           "profile": {"steps": 4, "neighbor_mean": 10.0,
                       "device_s": device_s or {}},
           "layers": core.layer_patterns(), spans.KEY: taken}
    return rec


def test_sweeps_bound_counts_pairs_particles_and_kept_rows():
    b = work_capped.sweeps_bound(1000, 10.0, 300.0)
    assert work_capped.KEPT_ROW_BYTES == 32
    assert b["flops"] == 1000 * 10.0 * 41
    assert b["bytes"] == 1000 * 48 + 300.0 * 32
    assert b["flops_s"] == pytest.approx(410000 / 67e12)
    assert b["bytes_s"] == pytest.approx(57600 / 3.35e12)
    assert b["bound_by"] == "bytes" and b["bound_s"] == b["bytes_s"]
    # with no kept row, the exact bound of work.py
    assert work_capped.sweeps_bound(1000, 10.0, 0.0) == \
        work.sweeps_bound(1000, 10.0)
    dense = work_capped.sweeps_bound(10, 1e6, 5.0)
    assert dense["bound_by"] == "operations"
    assert dense["bound_s"] == dense["flops_s"]


def test_readers_on_a_record_made_by_hand():
    taken = {"spans": [_span("binning.capped_sub", (0.5, 2.5)),
                       _span("binning.capped_sub", (4.0, 5.0)),
                       _span("sweeps.capped_gather", (1.0, 1.25)),
                       _span("sweeps.capped_gather", (1.5, 2.0)),
                       _span("sweeps.capped_gather", (5.0, 5.25)),
                       _span("binning.prepare", (0.0, 9.0))],
             "counts": {"capped.kept_rows": {"total": 1200.0, "times": 4},
                        "sweeps.rows_tested": {"total": 1.0, "times": 8}},
             "dropped": 0}
    # sweeps kernels 2 ms over 4 steps; a torch op no sweep
    dev = {"void density_band_t<1>(DensityBandArgs)": 0.0005,
           "void force_band_t<1>(ForceBandArgs)": 0.0015,
           "void at::native::elementwise_kernel<128, 2>": 0.25}
    rec = _record(taken, dev)
    bound = work_capped.sweeps_bound(1000, 10.0, 300.0)["bound_s"]
    got = {n: core.reader(n)(rec) for n in NEW}
    assert got == pytest.approx({
        "binning.capped_sub_stream_ms": 1.5,     # a mean of 2 and 1
        "sweeps.capped_gather_stream_ms_per_step": 0.25,   # 1 ms, 4 steps
        "sweeps.capped_roofline_pct": 100.0 * bound * 4 / 0.002})


def test_a_record_without_the_capped_spans_or_counter_gives_none():
    exact = {"spans": [_span("binning.prepare", (0.0, 1.0)),
                       _span("sweeps.sorted", (1.0, 2.0))],
             "counts": {"sweeps.rows_tested": {"total": 8.0, "times": 2}},
             "dropped": 0}
    dev = {"void force_band_t<0>(ForceBandArgs)": 0.002}
    assert all(core.reader(n)(_record(exact, dev)) is None for n in NEW)
    # the counter alone, with no sweeps kernel in the trace
    kept = dict(exact, counts={"capped.kept_rows": {"total": 3.0,
                                                    "times": 1}})
    assert core.reader("sweeps.capped_roofline_pct")(_record(kept)) is None
    # off the card: spans without a stream interval
    off = dict(exact, spans=[_span("binning.capped_sub", None),
                             _span("sweeps.capped_gather", None)])
    assert all(core.reader(n)(_record(off)) is None for n in NEW)
    # nothing recorded, and no profiled solve
    assert all(core.reader(n)(_record(None)) is None for n in NEW)
    assert all(core.reader(n)({"particles": 1}) is None for n in NEW)
    assert work_capped.kept_rows_per_step({}) is None


def test_a_traced_tiny_capped_run_reads_nothing_off_the_card(tmp_path):
    root, here = make_tiny(tmp_path, n=1500, steps=6, checked=2,
                           capped_candidates=4, pallas_block_t=256)
    res = run_tiny(root, here, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert not set(NEW) & set(res["metrics"])
    from smoothed_particle_hydrodynamics_tpu_torch.utils import trace

    assert trace.take() == {"spans": [], "counts": {}, "dropped": 0}
