"""The capped-noise and drift-trace tools of the port against the JAX
package's (``tools/capped_noise.py``, ``tools/trace_drift.py``), each run
as its ``main`` on the same splash state (the JAX scene's, handed to the
port; the JAX kernels in interpreter mode, the port's plain twins).

``capped_noise`` at 4096 particles, K_c 4, 1.25h cells (10 settling
steps): the same window and sub-frame bound, and the capped density's
rel-L2 against the exact oracle and its mean ratio within 1e-5 of the JAX
tool's (read from the two density arrays the JAX tool computes them
from).  ``trace_drift`` at 2048 particles, K_c 4, 2 settling steps and 8
traced: the same skin and the same steps rebinning.
"""

import re

import numpy as np
import torch

from smoothed_particle_hydrodynamics_tpu_torch.tools import (capped_noise,
                                                             trace_drift)

from test_torch_tools_fullrun import jax_scene_in_port, jax_tool
from smoothed_particle_hydrodynamics_tpu.models import make_scene as jscene

torch.set_num_threads(1)


def _interpret(name, **kw):
    return jscene(name, pallas_interpret=True, **kw)


class _Arrays:
    """numpy for the JAX tool, keeping every array its ``np.asarray``
    makes."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(np, name)

    def asarray(self, *a, **k):
        out = np.asarray(*a, **k)
        self.seen.append(out)
        return out


def _header(text: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith("n="))


def test_capped_noise_matches_jax(monkeypatch, capsys):
    jt = jax_tool("capped_noise")
    jt.make_scene = _interpret
    jt.np = _Arrays()
    jt.main(4096, 4, 1.25)
    rho_exact, rho_c = jt.np.seen[-2:]
    want_l2 = float(np.linalg.norm(rho_c - rho_exact)
                    / np.linalg.norm(rho_exact))
    want_ratio = float(rho_c.mean() / rho_exact.mean())
    want_head = _header(capsys.readouterr().out)

    monkeypatch.setattr(capped_noise, "make_scene", jax_scene_in_port)
    got = capped_noise.main(4096, 4, 1.25, device="cpu")
    assert _header(capsys.readouterr().out) == want_head
    assert abs(got["rel_l2"] - want_l2) <= 1e-5, (got, want_l2)
    assert abs(got["mean_ratio"] - want_ratio) <= 1e-5, (got, want_ratio)
    assert 0.0 < got["rel_l2"] < 1.0


def _rebins(text: str) -> list[bool]:
    return [("REBIN" in ln) for ln in text.splitlines()
            if ln.startswith("  step ")]


def test_trace_drift_matches_jax(monkeypatch, capsys):
    jt = jax_tool("trace_drift")
    jt.make_scene = _interpret
    jt.main(n=2048, k_c=4, csf=1.25, steps=8, settle=2)
    want = capsys.readouterr().out
    monkeypatch.setattr(trace_drift, "make_scene", jax_scene_in_port)
    got = trace_drift.main(2048, 4, 1.25, 8, settle=2, device="cpu")
    out = capsys.readouterr().out
    skin = re.search(r"skin=(\S+)", want).group(1)
    assert f"{got['skin']:.6f}" == skin
    assert re.search(r"skin=(\S+)", out).group(1) == skin
    assert _rebins(out) == _rebins(want) == got["rebinned"]
    assert len(got["rebinned"]) == 8 and any(got["rebinned"])
