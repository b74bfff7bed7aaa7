"""Eager step orchestration: rebin every step (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/step.py``).

``step`` is forces + KDK integration + diagnostics; ``drive_loop`` /
``run_steps`` run it on the host and ``simulate`` runs a whole
``cfg.num_steps + 1``-step run in blocks with a host callback.  The lazy
loop (``ops.lazy``) is the production path and is held against this eager
one.  Backends:

* ``"pallas"``: the port's sweep kernels, named after the JAX backend they
  replace; ``cfg.pallas_layout`` picks the sublane kernels (``sweeps_t``) or
  the lane kernels (``sweeps_lane``);
* ``"celllist"``: the portable plain-PyTorch cell-list sweeps (the default,
  as in the JAX package);
* ``"pairwise"``: the O(N^2) oracle.

Compat mode (the C++ reference's quirks) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Literal

import torch

from ..config import SphConfig, _f32
from ..state import (ParticleState, StepDiagnostics, make_step_diagnostics,
                     stack_diagnostics)
from . import celllist, pairwise, sweeps_lane, sweeps_t
from .celllist import CellListAux
from .integrate import energy_tally, kdk_integrate, reflect_boundary

Backend = Literal["pallas", "celllist", "pairwise"]


def compute_forces(cfg: SphConfig, state: ParticleState,
                   backend: Backend = "celllist"
                   ) -> tuple[torch.Tensor, torch.Tensor, CellListAux]:
    """(acceleration, density, aux) at the current state."""
    if cfg.capped_candidates and backend != "pallas":
        # only the sweeps implement the capped subsample; running exact
        # physics under a capped config would hide that the cap is off
        raise ValueError(f"capped_candidates={cfg.capped_candidates} is only "
                         f"implemented by the pallas backend (got "
                         f"{backend!r}); unset it for the exact backends")
    if backend == "celllist":
        return celllist.compute_step_quantities(cfg, state)
    if backend == "pallas":
        if cfg.pallas_layout == "sublane":
            return sweeps_t.compute_step_quantities(cfg, state)
        if cfg.pallas_layout == "lane":
            return sweeps_lane.compute_step_quantities(cfg, state)
        raise ValueError(f"unknown pallas_layout {cfg.pallas_layout!r} "
                         "('sublane' or 'lane')")
    if backend == "pairwise":
        rho = pairwise.compute_density(cfg, state)
        acc = pairwise.compute_acceleration(cfg, state, rho)
        zero = torch.zeros((), dtype=torch.int32, device=rho.device)
        return acc, rho, CellListAux(pairwise.neighbor_counts(cfg, state),
                                     zero, zero)
    if backend == "compat":
        raise NotImplementedError("the compat backend is not ported to the "
                                  "torch package yet")
    raise ValueError(f"unknown backend {backend!r} (torch package: 'pallas', "
                     "'celllist' or 'pairwise')")


def step(cfg: SphConfig, state: ParticleState, backend: Backend = "celllist"
         ) -> tuple[ParticleState, StepDiagnostics]:
    """One physics step (forces + KDK integration + diagnostics)."""
    if backend == "compat" or cfg.compat:
        raise NotImplementedError("compat mode is not ported to the torch "
                                  "package yet")
    acc, rho, aux = compute_forces(cfg, state, backend)
    state = state._replace(density=rho, neighbor_count=aux.neighbor_count)
    if cfg.second_kick == "full":
        new_state, tally = _kdk_full(cfg, state, acc, backend)
    else:
        new_state, tally = kdk_integrate(cfg, state, acc)
    return new_state, make_step_diagnostics(
        tally, aux.neighbor_count, aux.overflow_cells, aux.truncated_ranges)


def _kdk_full(cfg: SphConfig, state: ParticleState, acc: torch.Tensor,
              backend: Backend):
    """Second-order leapfrog: the closing half kick re-evaluates the full
    force (hydro + gravity) at the drifted positions, so the new state's
    acceleration and density are the second evaluation's."""
    dt = _f32(cfg.dt)
    v_half = state.velocity + acc * _f32(dt * 0.5)
    new_pos = state.position + v_half * _f32(dt / _f32(cfg.sim_scale))
    mid = state._replace(position=new_pos, velocity=v_half)
    acc2, rho2, _ = compute_forces(cfg, mid, backend)
    new_vel = v_half + acc2 * _f32(dt * 0.5)
    if cfg.boundary == "reflect":
        new_pos, new_vel = reflect_boundary(cfg, state.position, new_pos,
                                            new_vel)
    tally = energy_tally(cfg, new_pos, new_vel, state.mass)
    new_state = state._replace(position=new_pos, velocity=new_vel,
                               acceleration=acc2, density=rho2)
    return new_state, tally


def drive_loop(cfg: SphConfig, state: ParticleState, num_steps: int,
               backend: Backend = "celllist", collect_diags: bool = True
               ) -> tuple[ParticleState, StepDiagnostics | None]:
    """Host loop of ``num_steps`` steps; diagnostics stacked per step."""
    diags = []
    for _ in range(num_steps):
        state, d = step(cfg, state, backend)
        if collect_diags:
            diags.append(d)
    return state, (stack_diagnostics(diags) if collect_diags and diags else None)


def run_steps(cfg: SphConfig, state: ParticleState, num_steps: int,
              backend: Backend = "celllist"
              ) -> tuple[ParticleState, StepDiagnostics]:
    """``num_steps`` steps with the diagnostics stacked per step (the JAX
    package's ``lax.scan`` run; a host loop here)."""
    return drive_loop(cfg, state, num_steps, backend)


def simulate(cfg: SphConfig, state: ParticleState,
             backend: Backend = "celllist", steps_per_block: int = 50,
             callback: Callable | None = None
             ) -> tuple[ParticleState, StepDiagnostics]:
    """The whole run, ``cfg.num_steps + 1`` steps (the reference's loop runs
    step <= total), in blocks of ``steps_per_block``; between blocks
    ``callback(first_step_of_block, state, block_diags)`` runs on the
    host."""
    total = cfg.num_steps + 1
    blocks = []
    done = 0
    while done < total:
        k = min(steps_per_block, total - done)
        state, diags = drive_loop(cfg, state, k, backend)
        if callback is not None:
            callback(done, state, diags)
        blocks.append(diags)
        done += k
    return state, StepDiagnostics(*(torch.cat(f) for f in zip(*blocks)))
