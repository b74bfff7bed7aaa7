"""Initial conditions (counterpart of ``smoothed_particle_hydrodynamics_tpu/init.py``).

Random draws come from an explicit ``torch.Generator``: the same
distributions as the JAX package's ``jax.random`` draws, from a different
stream (the trade the JAX package made against the C++ reference's RNG).
The deterministic lattice layout matches the JAX package exactly; only the
jitter and the drop's random ball differ.  Draws are made on the
generator's device and the state is then moved to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SphConfig
from .state import ParticleState


def default_spacing(cfg: SphConfig) -> float:
    """Rest lattice spacing h/2: ~33 neighbors inside the support radius."""
    return float(cfg.h) * 0.5


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return lo + (hi - lo) * u


def _lattice_block(gen: torch.Generator, n: int, origin, dims_xyz,
                   spacing: float, jitter: float = 0.2) -> torch.Tensor:
    """n points on a jittered cubic lattice filling ``dims_xyz`` cells."""
    nx, ny, nz = dims_xyz
    idx = torch.arange(n, device=gen.device)
    iy, rem = idx // (nx * nz), idx % (nx * nz)
    iz, ix = rem // nx, rem % nx
    lattice = torch.stack([ix, iy, iz], dim=1).to(torch.float32)
    noise = _uniform(gen, (n, 3), -jitter, jitter)
    org = torch.tensor(origin, dtype=torch.float32, device=gen.device)
    return org + (lattice + 0.5 + noise) * spacing


def init_splash(gen: torch.Generator, cfg: SphConfig,
                spacing: float | None = None, drop_fraction: float = 0.15,
                drop_height: float = 0.6, speed: float = 5.0,
                device: torch.device | str = "cpu") -> ParticleState:
    """Splash: a falling drop over a resting pool.

    Pool depth and drop radius follow from N and the rest spacing, so the
    scene is packed at any particle count.  Rows ``[0, n_drop)`` are the
    drop, the rest the pool, as in the JAX package.
    """
    n = cfg.num_particles
    n_drop = int(n * drop_fraction)
    n_pool = n - n_drop
    box = np.asarray(cfg.box_max)
    dx = default_spacing(cfg) if spacing is None else spacing

    # pool: full floor footprint, height from N
    nx = max(int(box[0] * 0.98 / dx), 1)
    nz = max(int(box[2] * 0.98 / dx), 1)
    ny = -(-n_pool // (nx * nz))
    pos_pool = _lattice_block(gen, n_pool, (dx * 0.5,) * 3, (nx, ny, nz), dx)

    # drop: ball of radius from N at drop_height
    drop_radius = (3.0 * n_drop * dx ** 3 / (4.0 * np.pi)) ** (1.0 / 3.0)
    d = torch.randn((n_drop, 3), generator=gen, dtype=torch.float32,
                    device=gen.device)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    r = drop_radius * _uniform(gen, (n_drop,), 0.0, 1.0) ** (1.0 / 3.0)
    center = torch.tensor([box[0] * 0.5, box[1] * drop_height, box[2] * 0.5],
                          dtype=torch.float32, device=gen.device)
    pos_drop = center + d * r[:, None]
    vel_drop = torch.tensor([0.0, -speed, 0.0], dtype=torch.float32,
                            device=gen.device).expand(n_drop, 3)

    pos = torch.cat([pos_drop, pos_pool], dim=0)
    vel = torch.cat([vel_drop, torch.zeros(n_pool, 3, device=gen.device)], dim=0)
    hi = torch.tensor(box - 1e-4, dtype=torch.float32, device=gen.device)
    pos = torch.minimum(torch.clamp(pos, min=1e-4), hi)
    return ParticleState.from_arrays(pos.to(device), vel.to(device), cfg=cfg)
