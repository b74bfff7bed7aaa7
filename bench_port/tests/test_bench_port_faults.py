"""A whole CPU run of a tiny cell through the harness, sound and with the
timed path broken underneath: each fault turns ``correct`` false."""

import pytest
import torch

from conftest import run_tiny
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy


def test_sound_run_is_correct(tiny_bench):
    res = run_tiny(*tiny_bench, trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 30
    assert all(t["value"] <= t["limit"] for t in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert {"driver.host_ops_per_step", "binning.rebins_per_step"} <= set(
        res["metrics"])
    # the CPU has no device trace: no device metric is read
    assert "sweeps.roofline_pct" not in res["metrics"]


def _unchanged(orig):
    def step(cfg, carry):
        _, diags = orig(cfg, carry)
        return carry, diags           # the state the step was given
    return step


def _half_left_out(orig):
    def sweeps(cfg, p):
        acc, rho, count = orig(cfg, p)
        h = rho.shape[0] // 2         # the rest take the first half's mean
        rho, count, acc = rho.clone(), count.clone(), acc.clone()
        rho[h:] = rho[:h].mean()
        count[h:] = count[:h].float().mean().round().int()
        acc[h:] = acc[:h].mean(0)
        return acc, rho, count
    return sweeps


def _one_altered(orig):
    def sweeps(cfg, p):
        acc, rho, count = orig(cfg, p)
        rho = rho.clone()
        rho[rho.shape[0] // 3] *= 1.01    # one answer, where it is made
        return acc, rho, count
    return sweeps


def _never_rebins(orig):
    def spread(position, pos_bin):
        return torch.zeros((), device=position.device)
    return spread


@pytest.mark.parametrize("target,fault", [
    ("lazy_step", _unchanged),
    ("sweeps_sorted", _half_left_out),
    ("sweeps_sorted", _one_altered),
    ("drift_spread", _never_rebins),
])
def test_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, target,
                                          fault):
    monkeypatch.setattr(lazy, target, fault(getattr(lazy, target)))
    res = run_tiny(*tiny_bench)
    assert res["correct"] is False
    assert any(t["value"] > t["limit"] for t in res["checks"].values())


def test_control_script_reads_both_sides(tiny_bench):
    """``control.py``'s readings on the tiny cell: the program within
    every limit, the bfloat16 control outside them."""
    import json

    import compare
    import control
    import core
    from conftest import TINY

    root, here = tiny_bench
    cell = core.cell(core.load_bench(root), TINY, root, here)
    rec = control.readings(cell, 9, torch.device("cpu"), True, False)
    limits = json.loads((here / "limits" / "tiny.json").read_text())
    assert compare.judge(rec["program"], limits)[0]
    assert not compare.judge(rec["control"], limits)[0]
    assert rec["control"]["count_rows_differ"] > 0
