"""All-pairs O(N^2) oracle (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/pairwise.py``).

Every pair is tested and masked by d < h, so the result does not depend on
any binning.  Used by the tests and by ``chip_smoke.py`` at small N to hold
the sweep kernels to the physics; memory is O(N^2) (about 0.2 GB per
[N, N, 3] float32 tensor at N = 4096).
"""

from __future__ import annotations

import torch

from ..config import SphConfig, _f32
from ..state import ParticleState
from . import physics


def pair_distances(cfg: SphConfig, pos: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, N] scaled distances and the valid-pair mask (d < h, j != i)."""
    diff = pos[:, None, :] - pos[None, :, :]
    d2 = (diff * diff).sum(-1)
    d = torch.sqrt(d2) * _f32(cfg.sim_scale)
    n = pos.shape[0]
    not_self = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    return d, (d2 < cfg.h2) & not_self


def compute_density(cfg: SphConfig, state: ParticleState) -> torch.Tensor:
    d, mask = pair_distances(cfg, state.position)
    m_j = state.mass[None, :].expand_as(d)
    return physics.density_sum(cfg, m_j, d, mask, m_self=state.mass)


def compute_acceleration(cfg: SphConfig, state: ParticleState,
                         rho: torch.Tensor) -> torch.Tensor:
    """Full acceleration: hydro + central gravity + uniform gravity + CFL."""
    d, mask = pair_distances(cfg, state.position)
    n = state.n
    acc = physics.sph_acceleration(
        cfg,
        pos_i=state.position,
        vel_i=state.velocity,
        rho_i=rho,
        pos_j=state.position[None].expand(n, n, 3),
        vel_j=state.velocity[None].expand(n, n, 3),
        rho_j=rho[None, :].expand(n, n),
        m_j=state.mass[None, :].expand(n, n),
        d=d,
        mask=mask,
    )
    acc = acc + physics.central_gravity(cfg, state.position)
    acc = acc + torch.tensor(cfg.gravity, dtype=torch.float32,
                             device=acc.device)
    return physics.cfl_clamp(cfg, acc)


def neighbor_counts(cfg: SphConfig, state: ParticleState) -> torch.Tensor:
    _, mask = pair_distances(cfg, state.position)
    return mask.sum(-1).to(torch.int32)
