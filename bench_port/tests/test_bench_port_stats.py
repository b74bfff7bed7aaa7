"""The end-to-end readers, the rule that closes the window, the checked
steps drawn from the seed, and the work counts."""

import numpy as np
import pytest

import core
import window
import work


def _read(name, record):
    return core.reader(name)(record)


def test_rate_over_whole_solves_and_p95_over_blocks():
    rec = {"particles": 1000, "steps": 3 * 250, "window_s": 1.5,
           "block_ms": [1.0] * 94 + [2.0, 3.0, 4.0, 5.0, 6.0, 7.0],
           "setup_s": 4.25}
    assert _read("particle_steps_per_s", rec) == pytest.approx(5e5)
    assert _read("block_step_ms_p95", rec) == pytest.approx(
        np.percentile(rec["block_ms"], 95))
    assert 2.0 < _read("block_step_ms_p95", rec) < 3.0
    assert _read("setup_s", rec) == 4.25


def test_window_runs_whole_solves_until_one_more_would_not_fit(monkeypatch):
    clock = [100.0]
    lengths = iter([5.0, 2.0, 2.0, 2.0, 2.0])

    def fake_solve(*args, **kw):
        clock[0] += next(lengths)
        return {"block_ms": [1.0], "failed": 0, "rebins": 2,
                "neighbor_mean": [30.0]}

    monkeypatch.setattr(window, "solve", fake_solve)
    monkeypatch.setattr(window.time, "perf_counter", lambda: clock[0])
    out = window.timed_window(None, None, 250, 10, 12.0, None, {}, [])
    # after 5 + 2 s, 5 s are left: the slowest solve (5 s) fits once more;
    # after 9 s, 3 s are left, less than the slowest solve
    assert out["solves"] == 3
    assert out["window_s"] == 9.0
    assert out["steps"] == 750 and out["rebins"] == 6


def test_first_solve_always_runs(monkeypatch):
    monkeypatch.setattr(window, "solve", lambda *a, **k: {
        "block_ms": [1.0], "failed": 1, "rebins": 0, "neighbor_mean": [1.0]})
    out = window.timed_window(None, None, 5, 5, 0.0, None, {}, [])
    assert out["solves"] == 1 and out["failed"] == 1


def test_checked_steps_come_from_the_seed():
    a = window.draw_checks(2**33 + 7, 4, 2, 250, 10)
    assert a == window.draw_checks(2**33 + 7, 4, 2, 250, 10)
    assert a != window.draw_checks(2**33 + 8, 4, 2, 250, 10)
    assert a[(0, 0)] == 0 and len(a) == 4
    assert all(s in (0, 1) and 0 <= b < 25 and 0 <= j < 10
               for (s, b), j in a.items())
    last = window.draw_checks(3, 30, 1, 23, 10)   # 3 blocks, the last of 3
    assert len(last) == 3 and last[(0, 2)] < 3


def test_work_counts_pairs_and_bytes():
    b = work.sweeps_bound(1000, 30.0)
    assert b["flops"] == 1000 * 30.0 * 41
    assert b["bytes"] == 1000 * 48
    assert b["bound_s"] == max(b["flops"] / 67e12, b["bytes"] / 3.35e12)
    assert b["bound_by"] == "operations"
    assert work.sweeps_bound(1000, 1.0)["bound_by"] == "bytes"


def test_the_checked_copies_are_left_out_of_the_peak():
    import torch

    import run

    n = 10
    before = {"pos": torch.zeros(n, 3), "vel": torch.zeros(n, 3),
              "order": torch.arange(n)}
    after = {"count": torch.zeros(n, dtype=torch.int32),
             "rho": torch.zeros(n), "acc": torch.zeros(n, 3),
             "pos": torch.zeros(n, 3), "vel": torch.zeros(n, 3),
             "order": torch.arange(n)}
    sink = [{"before": before, "after": after}] * 4
    assert run.copies_bytes(sink) == 4 * 84 * n   # 84 bytes a particle
    assert run.copies_bytes([]) == 0
