"""Initial conditions (counterpart of ``smoothed_particle_hydrodynamics_tpu/init.py``).

Random draws come from an explicit ``torch.Generator``: the same
distributions as the JAX package's ``jax.random`` draws, from a different
stream (the trade the JAX package made against the C++ reference's RNG).
The deterministic parts (lattice layout, disk velocity field) match the JAX
package; only the random draws differ.  Draws are made on the generator's
device and the state is then moved to ``device`` (the card unless the caller
names another).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SphConfig, _f32
from .state import ParticleState, state_from_numpy


def init_rotating_sphere(gen: torch.Generator, cfg: SphConfig,
                         radius: float = 2.0, v_scale: float = 20.0,
                         v_jitter: float = 0.25,
                         device: torch.device | str = "cuda"
                         ) -> ParticleState:
    """Rotating gas sphere: a uniform ball about the box centre (random
    direction times a cube-root radius) with the near-Keplerian tangential
    velocity of ``disk_velocity`` plus a uniform vertical jitter."""
    n = cfg.num_particles
    center = torch.tensor(cfg.central_pos, dtype=torch.float32,
                          device=gen.device)
    direction = torch.randn((n, 3), generator=gen, dtype=torch.float32,
                            device=gen.device)
    direction = direction / torch.linalg.norm(direction, dim=1, keepdim=True)
    r = radius * _uniform(gen, (n,), 0.0, 1.0) ** (1.0 / 3.0)
    pos = center + direction * r[:, None]
    vel = disk_velocity(cfg, pos, v_scale=v_scale)
    vel[:, 1] += _uniform(gen, (n,), -v_jitter, v_jitter)
    return ParticleState.from_arrays(pos.to(device), vel.to(device), cfg=cfg)


def disk_velocity(cfg: SphConfig, pos: torch.Tensor, v_scale: float = 20.0
                  ) -> torch.Tensor:
    """Tangential velocity v = v_scale (dist + h/2)^(-1/2) in the x-z plane,
    y zero; ``dist`` is the full 3-D distance from the box centre."""
    center = torch.tensor(cfg.central_pos, dtype=torch.float32,
                          device=pos.device)
    rel = pos - center
    dist = torch.linalg.norm(rel, dim=1)
    phi = torch.atan2(rel[:, 2], rel[:, 0])
    vmag = v_scale * (dist + _f32(cfg.h_scaled * 0.5)) ** -0.5
    vx = vmag * -torch.sin(phi)
    vz = vmag * torch.cos(phi)
    return torch.stack([vx, torch.zeros_like(vx), vz], dim=1)


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


def _clip_to_box(pos: torch.Tensor, box: np.ndarray) -> torch.Tensor:
    hi = torch.tensor(box - 1e-4, dtype=torch.float32, device=pos.device)
    return torch.minimum(torch.clamp(pos, min=1e-4), hi)


def init_dam_break(gen: torch.Generator, cfg: SphConfig,
                   spacing: float | None = None,
                   base_fraction: tuple[float, float] = (0.35, 0.7),
                   device: torch.device | str = "cuda") -> ParticleState:
    """Dam-break column at rest in a box corner at the rest spacing: its
    footprint is ``base_fraction`` of the floor, its height follows from N.
    Raises ValueError when the column would not fit under 0.95 of the box
    height."""
    n = cfg.num_particles
    box = np.asarray(cfg.box_max)
    dx = default_spacing(cfg) if spacing is None else spacing
    nx = max(int(box[0] * base_fraction[0] / dx), 1)
    nz = max(int(box[2] * base_fraction[1] / dx), 1)
    ny = -(-n // (nx * nz))
    if ny * dx > box[1] * 0.95:
        raise ValueError(
            f"dam_break: {n} particles at spacing {dx:g} overflow the box; "
            "increase the grid/box or the spacing")
    pos = _clip_to_box(_lattice_block(gen, n, (dx, dx, dx), (nx, ny, nz), dx),
                       box)
    return ParticleState.from_arrays(
        pos.to(device), torch.zeros(n, 3, device=device), cfg=cfg)


def init_splash(gen: torch.Generator, cfg: SphConfig,
                spacing: float | None = None, drop_fraction: float = 0.15,
                drop_height: float = 0.6, speed: float = 5.0,
                device: torch.device | str = "cuda") -> ParticleState:
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
    pos = _clip_to_box(pos, box)
    return ParticleState.from_arrays(pos.to(device), vel.to(device), cfg=cfg)


def load_state(path: str, device: torch.device | str = "cuda"
               ) -> ParticleState:
    """A state saved as ``.npz`` by either package (``utils.io.save_state``
    or a checkpoint) on ``device``."""
    with np.load(path) as d:
        return state_from_numpy({k: d[k] for k in d.files}, device)
