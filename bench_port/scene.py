"""Initial conditions from ``--seed``: a frozen copy of the scenes' draws
(the port's ``init.py::init_splash`` and ``init_dam_break``, with the same
``torch.Generator`` calls in the same order), made by a generator on the
device the state lives on.

A configuration file's ``initial`` block names the scene (``kind``) and
its parameters; ``draw`` returns (positions, velocities, masses), the
tensors that both the program and the reference are handed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from spec import constants


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


def _splash(gen, n, box, dx, drop_fraction, drop_height, speed):
    """A falling drop over a resting pool; rows [0, n_drop) are the drop."""
    n_drop = int(n * drop_fraction)
    n_pool = n - n_drop
    nx = max(int(box[0] * 0.98 / dx), 1)
    nz = max(int(box[2] * 0.98 / dx), 1)
    ny = -(-n_pool // (nx * nz))
    pos_pool = _lattice_block(gen, n_pool, (dx * 0.5,) * 3, (nx, ny, nz), dx)
    drop_radius = (3.0 * n_drop * dx ** 3 / (4.0 * math.pi)) ** (1.0 / 3.0)
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
    vel = torch.cat([vel_drop, torch.zeros(n_pool, 3, device=gen.device)])
    return _clip_to_box(pos, box), vel


def _dam_break(gen, n, box, dx, base_fraction):
    """A column at rest in a box corner; its height follows from n."""
    nx = max(int(box[0] * base_fraction[0] / dx), 1)
    nz = max(int(box[2] * base_fraction[1] / dx), 1)
    ny = -(-n // (nx * nz))
    if ny * dx > box[1] * 0.95:
        raise ValueError(f"dam_break: {n} particles at spacing {dx:g} "
                         "overflow the box")
    pos = _lattice_block(gen, n, (dx, dx, dx), (nx, ny, nz), dx)
    return _clip_to_box(pos, box), torch.zeros(n, 3, device=gen.device)


def draw(config: dict, seed: int, device: torch.device
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(positions [N, 3], velocities [N, 3], masses [N]) of ``config``'s
    scene, drawn from ``seed`` on ``device``."""
    c = constants(config["sph"])
    ic = dict(config["initial"])
    kind = ic.pop("kind")
    dx = config["sph"]["h"] * ic.pop("spacing_over_h")
    box = np.asarray(c["box"])
    gen = torch.Generator(device=device).manual_seed(seed)
    if kind == "splash":
        pos, vel = _splash(gen, c["n"], box, dx, **ic)
    elif kind == "dam_break":
        pos, vel = _dam_break(gen, c["n"], box, dx, tuple(ic["base_fraction"]))
    else:
        raise ValueError(f"unknown initial conditions {kind!r}")
    mass = torch.full((c["n"],), c["particle_mass"], dtype=torch.float32,
                      device=device)
    return pos.contiguous(), vel.contiguous(), mass
