"""Scene catalogue (counterpart of ``smoothed_particle_hydrodynamics_tpu/models/scenes.py``).

Each scene is a named factory returning ``(SphConfig, ParticleState)`` with
the JAX package's defaults.  The port has ``splash`` so far (the 1M
drop-into-pool scene of the headline benchmark); ``disk``, ``dam_break``,
``honey`` and ``dam_break_10m`` are still to be ported.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SphConfig
from ..init import init_splash
from ..state import ParticleState


def _splash(n: int = 1_000_000, device: torch.device | str = "cpu",
            seed: int = 11, **overrides) -> tuple[SphConfig, ParticleState]:
    defaults = dict(
        num_particles=n,
        boundary="reflect",
        gravity=(0.0, -9.81, 0.0),
        central_mass=0.0,
        rho0=1.0,
        stiffness=1.0,
        viscosity=0.05,
        damping=0.5,
        total_time=0.25,
        include_self_density=True,
        second_kick="none",
        cell_size_factor=1.0,
        neighborhood="cell27",
        grid_nx=128, grid_ny=128, grid_nz=128,   # 12.8^3 box of h-cells
        cell_capacity=64,
        range_slice=128,
    )
    defaults.update(overrides)
    defaults["num_particles"] = overrides.get("num_particles", n)
    cfg = SphConfig(**defaults)
    gen = torch.Generator().manual_seed(seed)
    state = init_splash(gen, cfg, device=device)
    return cfg, state


SCENES: dict[str, Callable[..., tuple[SphConfig, ParticleState]]] = {
    "splash": _splash,
}


def make_scene(name: str, **overrides) -> tuple[SphConfig, ParticleState]:
    """``make_scene("splash", device="cuda", seed=11, num_particles=...)``:
    ``device`` and ``seed`` go to the initial conditions, every other
    keyword overrides a config field."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")
    return SCENES[name](**overrides)
