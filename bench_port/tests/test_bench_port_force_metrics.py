"""The reader of ``sweeps.force_lane_use_pct`` (the port's counters
``sweeps.force_pairs`` and ``sweeps.force_rounds``): on records made by
hand, on records without the counters (a port that keeps none, a fused
path without K2, no profiled solve), and on traced CPU runs of the tiny
cell, exact and capped, where K2's twin counts them."""

import pytest

import core
import spans
from conftest import make_tiny, run_tiny

NAME = "sweeps.force_lane_use_pct"


def _record(counts):
    taken = None if counts is None else {"spans": [], "counts": counts,
                                         "dropped": 0}
    return {"particles": 1000, "profile": {"steps": 4, "neighbor_mean": 10.0},
            spans.KEY: taken}


def test_reader_on_a_record_made_by_hand():
    counts = {"sweeps.force_pairs": {"total": 4000.0, "times": 2},
              "sweeps.force_rounds": {"total": 500.0, "times": 2},
              "sweeps.rows_tested": {"total": 9.0, "times": 8}}
    assert core.reader(NAME)(_record(counts)) == pytest.approx(
        100.0 * 4000 / (32 * 500))


@pytest.mark.parametrize("counts", [
    None, {}, {"sweeps.rows_tested": {"total": 9.0, "times": 8}},
    {"sweeps.force_pairs": {"total": 0.0, "times": 1},
     "sweeps.force_rounds": {"total": 0.0, "times": 1}},
    {"sweeps.force_pairs": {"total": 10.0, "times": 1}}],
    ids=["nothing-recorded", "no-counts", "no-k2-counter", "no-round",
         "pairs-alone"])
def test_a_record_without_drain_rounds_gives_none(counts):
    assert core.reader(NAME)(_record(counts)) is None
    assert core.reader(NAME)({"particles": 1}) is None


@pytest.mark.parametrize("sph", [{}, dict(capped_candidates=4,
                                          pallas_block_t=256)],
                         ids=["exact", "capped"])
def test_a_traced_tiny_run_reads_the_lane_use(tmp_path, sph):
    root, here = make_tiny(tmp_path, n=1500, steps=6, checked=2, **sph)
    res = run_tiny(root, here, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    m = res["metrics"][NAME]
    assert m["unit"] == "%" and 0.0 < m["value"] <= 100.0
    # an untraced run has no profiled solve to read
    assert NAME not in run_tiny(root, here)["metrics"]
