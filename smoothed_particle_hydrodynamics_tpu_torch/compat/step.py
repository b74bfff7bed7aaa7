"""Quirk-faithful density, force and step over the compat neighbor tables
(counterpart of ``smoothed_particle_hydrodynamics_tpu/compat/step.py``):
the reference's density (no self term), its forces with quirks 1-2, and KDK
with the gravity-only second kick and the compat energy tallies, consuming
the stored neighbor ids and distances in the order the reference produced
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SphConfig
from ..ops import physics
from ..ops.celllist import CellListAux
from ..ops.integrate import kdk_integrate
from ..state import ParticleState, StepDiagnostics, make_step_diagnostics
from .neighbors import CompatNeighbors, find_neighbors_compat

_LANES = 8   # XLA:CPU's vector width for the density's slot sum


def _valid_ids(state: ParticleState, nb: CompatNeighbors
               ) -> tuple[torch.Tensor, torch.Tensor]:
    slots = torch.arange(nb.ids.shape[1], device=nb.ids.device)
    valid = slots < nb.count[:, None]
    return valid, nb.ids.long().clamp(0, state.n - 1)


def compat_density(cfg: SphConfig, state: ParticleState,
                   nb: CompatNeighbors) -> torch.Tensor:
    """rho_i over the stored table, reusing the stored scaled distances (no
    self term; the reference's redundant d > h recheck kept).

    The sum is XLA:CPU's, so rho equals the JAX package's bit for bit on
    any device: ``h^2 - d^2`` contracted, then the slots summed as an
    8-lane vector reduction (lane k takes slots k, k + 8, ... with fused
    multiply-adds; the lanes are halved 8 -> 4 -> 2 -> 1)."""
    valid, ids = _valid_ids(state, nb)
    d = nb.dists
    t = physics.fma32(-d, d, torch.full_like(d, cfg.h_scaled2))
    w = cfg.poly6_norm * t * t * t
    w = torch.where(valid & (d <= cfg.h_scaled), w, torch.zeros_like(w))
    n, slots = w.shape
    pad = (0, -slots % _LANES)     # zero slots add nothing
    m_j = F.pad(state.mass[ids], pad).view(n, -1, _LANES)
    w = F.pad(w, pad).view(n, -1, _LANES)
    acc = torch.zeros(n, _LANES, dtype=torch.float32, device=w.device)
    for r in range(w.shape[1]):
        acc = physics.fma32(m_j[:, r], w[:, r], acc)
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0]


def compat_acceleration(cfg: SphConfig, state: ParticleState,
                        rho: torch.Tensor, nb: CompatNeighbors
                        ) -> torch.Tensor:
    """The force loop with quirks 1-2, in stored neighbor order, plus the
    central gravity, CFL-clamped (no uniform gravity, as in the
    reference)."""
    valid, ids = _valid_ids(state, nb)
    acc = physics.sph_acceleration(
        cfg.replace(compat=True), pos_i=state.position, vel_i=state.velocity,
        rho_i=rho, pos_j=state.position[ids], vel_j=state.velocity[ids],
        rho_j=rho[ids], m_j=state.mass[ids], d=nb.dists, mask=valid)
    acc = acc + physics.central_gravity(cfg, state.position)
    return physics.cfl_clamp(cfg, acc)


def compute_compat_quantities(cfg: SphConfig, state: ParticleState
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         CellListAux]:
    """(acceleration, density, aux) with the reference's neighbor sets."""
    nb = find_neighbors_compat(cfg, state.position)
    rho = compat_density(cfg, state, nb)
    acc = compat_acceleration(cfg, state, rho, nb)
    aux = CellListAux(
        neighbor_count=nb.count, overflow_cells=nb.overflow_cells,
        truncated_ranges=torch.zeros((), dtype=torch.int32,
                                     device=rho.device))
    return acc, rho, aux


def compat_step(cfg: SphConfig, state: ParticleState
                ) -> tuple[ParticleState, StepDiagnostics]:
    """One reference-exact step (compat binning, neighbors, density,
    acceleration, KDK)."""
    acc, rho, aux = compute_compat_quantities(cfg, state)
    state = state._replace(density=rho, neighbor_count=aux.neighbor_count)
    new_state, tally = kdk_integrate(cfg.replace(compat=True), state, acc)
    return new_state, make_step_diagnostics(tally, aux.neighbor_count,
                                            aux.overflow_cells)
