"""The profile tools of the port (``profile_prepare``, ``profile_lazy``,
``profile_pallas``, ``profile_slab``, ``profile_step``), on the CPU at small
sizes.

``profile_prepare``'s rebuild from ``prepare_t``'s helpers gives
``prepare_t``'s ``PreparedT`` bit for bit (exact, capped, capped fused);
``profile_lazy``'s step with no stub gives ``lazy_step``'s carry and
diagnostics bit for bit over steps that rebin; ``profile_pallas``,
``profile_slab --phases`` and ``profile_step`` print every phase name the
JAX tool prints (read from the JAX tool's source: its ``bench`` names, its
ablation variants and the labels it formats).
"""

import ast
import os

import pytest
import torch

from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
from smoothed_particle_hydrodynamics_tpu_torch.ops import lazy
from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as pst
from smoothed_particle_hydrodynamics_tpu_torch.tools import (
    Phases, profile_lazy, profile_pallas, profile_prepare, profile_slab,
    profile_step)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, tuple):
        assert type(a) is type(b), what
        for k, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{k}]")
    else:
        assert a == b, what


@pytest.mark.parametrize("mode", ["exact", "capped", "fused"])
def test_profile_prepare_composes_prepare_t(mode):
    r = profile_prepare.main(2048, 0 if mode == "exact" else 4,
                             steps_settle=2, device="cpu", iters=1)
    cfg, st = r["cfg"], r["state"]
    composed = r["composed"]
    if mode == "fused":
        cfg = cfg.replace(capped_fused=True)
        composed = profile_prepare.compose(cfg, st, Phases(CPU), iters=1)
    want = pst.prepare_t(cfg, st)
    for f in want._fields:
        a, b = getattr(composed, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    if mode != "exact":
        assert composed.sub_perm is not None


@pytest.mark.parametrize("k_c", [0, 4])
def test_profile_lazy_full_step_is_lazy_step(k_c):
    ov = dict(num_particles=1024, cell_size_factor=1.25, pallas_window_t=64)
    if k_c:
        ov.update(capped_candidates=k_c)
    cfg, state = make_scene("splash", device="cpu", **ov)
    a = b = lazy.init_lazy(cfg, state)
    step = profile_lazy.step_fn(cfg)
    for k in range(8):
        a, da = lazy.lazy_step(cfg, a)
        b, db = step(b)
        _equal(b, a, f"carry, step {k}")
        _equal(db, da, f"diagnostics, step {k}")
    assert a.rebin_count >= 1


def _jax_phase_names(name: str) -> set[str]:
    """The phase names a JAX tool prints: the first argument of each
    ``bench`` call, the labels of its ``variants``, a label formatted from
    a constant (``f"{'lazy step end-to-end':34s}"``) and a default label
    (``label or 'full step'``)."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{name}.py")).read())
    names = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", "") == "bench"
                and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
        elif (isinstance(node, ast.Assign)
              and getattr(node.targets[0], "id", "") == "variants"):
            names |= {e.elts[0].value for e in node.value.elts}
        elif (isinstance(node, ast.FormattedValue)
              and isinstance(node.value, ast.Constant)):
            names.add(node.value.value)
        elif isinstance(node, ast.BoolOp) and isinstance(node.op, ast.Or):
            names |= {v.value for v in node.values
                      if isinstance(v, ast.Constant)}
    return names


def _printed(capsys, name, run) -> tuple[set, str]:
    run()
    out = capsys.readouterr().out
    names = _jax_phase_names(name)
    assert names, name
    return {n for n in names if n not in out}, out


def test_profile_pallas_prints_the_jax_phases(capsys):
    missing, out = _printed(capsys, "profile_pallas", lambda: (
        profile_pallas.main(2048, 4, device="cpu", steps_settle=2, iters=1,
                            lazy_iters=2)))
    assert not missing, missing
    assert "sub gather force   [S,7]" in out and " ms host" in out


def test_profile_slab_prints_the_jax_phases(capsys):
    missing, out = _printed(capsys, "profile_slab", lambda: (
        profile_slab.main(1024, 4, steps=2, settle=1, phases=True,
                          device="cpu")))
    assert not missing, missing
    assert "no kdk+tally (frozen motion)" in out


@pytest.mark.parametrize("mode", ["exact", "fused"])
def test_profile_slab_stubs_each_mode(mode, capsys, monkeypatch):
    """The ablation's stubs replace the callers of the mode's sweeps and
    are put back after each variant."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps, slabs)

    before = {k: getattr(slab_sweeps, k) for k in (
        "density_local", "force_local", "density_sub_local",
        "fused_local_capped")}
    kdk = slabs.kdk_integrate
    if mode == "fused":
        monkeypatch.setattr(profile_slab, "make_scene",
                            lambda name, **kw: make_scene(
                                name, capped_fused=True, **kw))
    r = profile_slab.main(1024, 0 if mode == "exact" else 4, steps=2,
                          settle=1, phases=True, device="cpu")
    assert len(r["steady_rebin_ms"]) == 6
    assert {k: getattr(slab_sweeps, k) for k in before} == before
    assert slabs.kdk_integrate is kdk
    assert "machinery only (all stubbed)" in capsys.readouterr().out


def test_profile_step_prints_the_jax_phases(capsys):
    missing, _ = _printed(capsys, "profile_step", lambda: (
        profile_step.main(2048, 512, device="cpu", iters=1)))
    assert not missing, missing
