"""The study tools' entry points (``smoothed_particle_hydrodynamics_tpu_torch
/tools/``): one per JAX tool, with its file name and positional arguments,
measuring the card by default and stopping, not falling back to the CPU,
when there is none; none imports JAX or the JAX package.
"""

import argparse
import ast
import importlib
import inspect
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "smoothed_particle_hydrodynamics_tpu_torch"
TOOLS = ("capped_fullrun", "capped_noise", "trace_drift", "ab_engines",
         "profile_pallas", "profile_prepare", "profile_lazy", "profile_slab",
         "profile_step", "ab_dials", "ab_slab", "microbench",
         "probe_dma_floor", "probe_cond", "probe_scan", "probe_dispatch",
         "probe_tally", "scale_projection")


def _jax_positionals(name: str) -> list:
    """The defaults of the JAX tool's positional arguments, in order: the
    ``int(a[i]) if len(a) > i else D`` / ``sys.argv[i + 1]`` forms of its
    ``__main__`` block."""
    tree = ast.parse(open(os.path.join(REPO, "tools", f"{name}.py")).read())
    found = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.IfExp)
                and isinstance(node.test, ast.Compare)
                and isinstance(node.test.left, ast.Call)
                and getattr(node.test.left.func, "id", "") == "len"
                and isinstance(node.test.comparators[0], ast.Constant)):
            continue
        i = node.test.comparators[0].value
        d = node.orelse
        if isinstance(d, ast.Constant):
            found[i] = d.value
        elif isinstance(d, ast.UnaryOp):
            found[i] = ast.literal_eval(d)
    return [found[i] for i in sorted(found)]


def _port_positionals(mod, monkeypatch) -> list:
    """The defaults of the positional arguments ``mod.cli`` declares (its
    parser is read as it parses, before anything runs)."""
    actions = []

    def grab(self, argv=None, namespace=None):
        actions.extend(self._actions)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(SystemExit):
        mod.cli([])
    return [a.default for a in actions if not a.option_strings]


@pytest.mark.parametrize("name", TOOLS)
def test_tool_defaults_to_the_card_and_stops_without_one(name):
    mod = importlib.import_module(f"{PKG}.tools.{name}")
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            mod.cli([])
        assert "no CUDA device" in str(e.value.code)


@pytest.mark.parametrize("name", [t for t in TOOLS
                                  if t not in ("capped_fullrun",
                                               "microbench")])
def test_tool_positionals_are_the_jax_tools(name, monkeypatch):
    """The same positional arguments, in the same order, with the same
    defaults (``only,names`` defaults to every variant: None).  The JAX
    tools index ``sys.argv`` or ``sys.argv[1:]``; either way the order of
    the indices is the order of the arguments."""
    mod = importlib.import_module(f"{PKG}.tools.{name}")
    want = _jax_positionals(name)
    got = _port_positionals(mod, monkeypatch)
    assert got == want


def test_tool_without_a_card_exits_nonzero():
    """As a user runs it: with no card and no ``--device cpu``, exit
    status 1 and the reason on stderr, before any measurement."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", f"{PKG}.tools.trace_drift"],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 1
    assert "no CUDA device" in r.stderr and r.stdout == ""


def test_tools_import_no_jax():
    code = (f"import sys\n"
            f"import {', '.join(f'{PKG}.tools.{t}' for t in TOOLS)}\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'smoothed_particle_hydrodynamics_"
            "tpu' or m.startswith('smoothed_particle_hydrodynamics_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
