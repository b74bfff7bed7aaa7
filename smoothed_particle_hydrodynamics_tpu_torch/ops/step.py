"""Eager step orchestration: rebin every step (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/step.py``).

``step`` is forces + KDK integration + diagnostics; ``drive_loop`` runs it on
the host.  The lazy loop (``ops.lazy``) is the production path and is
held against this eager one.  Backends: ``"pallas"`` (the port's sweep
kernels, named after the JAX backend they replace) and ``"pairwise"`` (the
O(N^2) oracle).
"""

from __future__ import annotations

from typing import Literal

import torch

from ..config import SphConfig
from ..state import (ParticleState, StepDiagnostics, make_step_diagnostics,
                     stack_diagnostics)
from . import pairwise, sweeps_t
from .integrate import kdk_integrate

Backend = Literal["pallas", "pairwise"]


def compute_forces(cfg: SphConfig, state: ParticleState,
                   backend: Backend = "pallas"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(acceleration, density, neighbor_count, truncated_ranges) at the
    current state."""
    if cfg.capped_candidates and backend != "pallas":
        # only the sweeps implement the capped subsample; running exact
        # physics under a capped config would hide that the cap is off
        raise ValueError(f"capped_candidates={cfg.capped_candidates} is only "
                         f"implemented by the pallas backend (got "
                         f"{backend!r}); unset it for the exact backends")
    if backend == "pallas":
        return sweeps_t.compute_step_quantities(cfg, state)
    if backend == "pairwise":
        rho = pairwise.compute_density(cfg, state)
        acc = pairwise.compute_acceleration(cfg, state, rho)
        zero = torch.zeros((), dtype=torch.int32, device=rho.device)
        return acc, rho, pairwise.neighbor_counts(cfg, state), zero
    raise ValueError(f"unknown backend {backend!r} (torch package: 'pallas' "
                     "or 'pairwise')")


def step(cfg: SphConfig, state: ParticleState, backend: Backend = "pallas"
         ) -> tuple[ParticleState, StepDiagnostics]:
    """One physics step (forces + KDK integration + diagnostics)."""
    acc, rho, ncount, truncated = compute_forces(cfg, state, backend)
    state = state._replace(density=rho, neighbor_count=ncount)
    new_state, tally = kdk_integrate(cfg, state, acc)
    return new_state, make_step_diagnostics(tally, ncount, truncated)


def drive_loop(cfg: SphConfig, state: ParticleState, num_steps: int,
               backend: Backend = "pallas", collect_diags: bool = True
               ) -> tuple[ParticleState, StepDiagnostics | None]:
    """Host loop of ``num_steps`` steps; diagnostics stacked per step."""
    diags = []
    for _ in range(num_steps):
        state, d = step(cfg, state, backend)
        if collect_diags:
            diags.append(d)
    return state, (stack_diagnostics(diags) if collect_diags and diags else None)
