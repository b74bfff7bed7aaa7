"""A whole CPU run of a tiny cell through the harness, exact and capped
(K_c = 4, 256-row blocks), sound and with the timed path broken
underneath: each fault turns ``correct`` false."""

import pytest
import torch

from conftest import make_tiny, run_tiny
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy, sweeps_t
from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState

CAPPED = {"capped_candidates": 4, "pallas_block_t": 256}


@pytest.fixture
def tiny_capped(tmp_path):
    return make_tiny(tmp_path, **CAPPED)


@pytest.fixture(params=["exact", "capped"])
def tiny_cell(request, tmp_path):
    return make_tiny(tmp_path, **(CAPPED if request.param == "capped" else {}))


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


@pytest.mark.parametrize("fused", [False, True])
def test_capped_sound_run_is_correct(tmp_path, monkeypatch, fused):
    """The capped path and the fused one (the pre-pass and one fused
    walk), which sums the same candidates."""
    import run

    copies = []
    check_steps = run.check_steps

    def spy(config, sink, mass, control=False):
        copies.extend(s["after"] for s in sink)
        return check_steps(config, sink, mass, control)

    monkeypatch.setattr(run, "check_steps", spy)
    res = run_tiny(*make_tiny(tmp_path, **CAPPED, capped_fused=fused))
    assert res["correct"] is True and res["failed"] == 0
    assert all(t["value"] <= t["limit"] for t in res["checks"].values())
    # each copy holds a frame of every particle, and some checked step's
    # bins came from a rebin: another frame than the callers' order
    ids = torch.arange(copies[0]["order"].shape[0])
    assert all(torch.equal(a["bin_from"].sort().values, ids) for a in copies)
    assert any(not torch.equal(a["bin_from"], ids) for a in copies)


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
def test_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, target,
                                          fault):
    monkeypatch.setattr(lazy, target, fault(getattr(lazy, target)))
    res = run_tiny(*tiny_cell)
    assert res["correct"] is False
    assert any(t["value"] > t["limit"] for t in res["checks"].values())


def _hash_is_row(orig):
    return lambda idx: idx.long()     # the kept set by row, not by hash


def _reweight_dropped(orig):
    def sub_frame(cfg, cid_sorted, mass_s):
        return orig(cfg.replace(capped_reweight=False), cid_sorted, mass_s)
    return sub_frame


def _kept_set_frozen(orig):
    """At each rebin the kept set hashes each particle's original id, as
    the first binning did, and not its row in the frame being binned: a
    cell's kept set stays as it was while its members stay."""
    def bin_(cfg, state, order, *args):
        if order is None:
            return orig(cfg, state, order, *args)
        back = torch.empty_like(order)
        back[order] = torch.arange(order.shape[0], device=order.device)
        return orig(cfg, ParticleState(*(t[back] for t in state)), None,
                    *args)
    return bin_


@pytest.mark.parametrize("module,target,fault", [
    (sweeps_t, "_hash32", _hash_is_row),
    (sweeps_t, "_sub_frame", _reweight_dropped),
    (lazy, "_bin", _kept_set_frozen),
], ids=["hash_is_row", "reweight_dropped", "kept_set_frozen"])
def test_broken_capped_path_is_not_correct(tiny_capped, monkeypatch, module,
                                           target, fault):
    monkeypatch.setattr(module, target, fault(getattr(module, target)))
    res = run_tiny(*tiny_capped)
    assert res["correct"] is False
    assert any(t["value"] > t["limit"] for t in res["checks"].values())


def test_control_script_reads_both_sides(tiny_cell):
    """``control.py``'s readings on the tiny cell: the program within
    every limit, the bfloat16 control (in capped mode handed the same
    bins) outside them."""
    import json

    import compare
    import control
    import core
    from conftest import TINY

    root, here = tiny_cell
    cell = core.cell(core.load_bench(root), TINY, root, here)
    rec = control.readings(cell, 9, torch.device("cpu"), True, False)
    limits = json.loads((here / "limits" / "tiny.json").read_text())
    assert compare.judge(rec["program"], limits)[0]
    assert not compare.judge(rec["control"], limits)[0]
    assert rec["control"]["count_rows_differ"] > 0
