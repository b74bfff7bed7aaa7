"""Scene catalogue (counterpart of ``smoothed_particle_hydrodynamics_tpu/models/scenes.py``).

Each scene is a named factory returning ``(SphConfig, ParticleState)`` with
the JAX package's defaults and seeds:

1. ``disk``          the reference's rotating gas disk (32k particles, 2h
                     cells, octant stencil), seed 42;
2. ``dam_break``     100k-particle dam break in a reflecting box, seed 7;
3. ``splash``        1M-particle drop into a pool, seed 11;
4. ``honey``         the disk at high viscosity and low stiffness, seed 42;
5. ``dam_break_10m`` the dam break at 10M particles on a 256^3 grid.

The state is made on ``device``, the card unless the caller names another.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SphConfig
from ..init import init_dam_break, init_rotating_sphere, init_splash
from ..state import ParticleState

Device = torch.device | str


# each scene's own size and config defaults, the one place they are stated
_DAM_BREAK = dict(
    boundary="reflect",
    gravity=(0.0, -9.81, 0.0),
    central_mass=0.0,           # pure fluid scene: no point mass
    rho0=1.0,
    stiffness=1.0,
    viscosity=0.1,
    damping=0.5,
    total_time=0.5,
    include_self_density=True,
    second_kick="none",
    # h-sized cells + 27-stencil on a 6.4^3 box
    cell_size_factor=1.0,
    neighborhood="cell27",
    grid_nx=64, grid_ny=64, grid_nz=64,
)
_SPLASH = dict(
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
_CONFIGS: dict[str, tuple[int, dict]] = {
    "disk": (32 * 1024, {}),
    "dam_break": (100_000, _DAM_BREAK),
    "splash": (1_000_000, _SPLASH),
    "honey": (32 * 1024, dict(viscosity=10.0, stiffness=1e-4)),
    "dam_break_10m": (10_000_000, dict(  # 25.6^3, h-cells
        _DAM_BREAK, grid_nx=256, grid_ny=256, grid_nz=256, cell_capacity=64,
        range_slice=96)),
}


def scene_config(name: str, **overrides) -> SphConfig:
    """The config ``make_scene(name, **overrides)`` returns, without drawing
    the particles; every keyword overrides a config field."""
    _known(name)
    n, defaults = _CONFIGS[name]
    kw = dict(defaults, num_particles=n)
    kw.update(overrides)
    return SphConfig(**kw)


def _draw(name: str, init, device: Device, seed: int, overrides: dict
          ) -> tuple[SphConfig, ParticleState]:
    cfg = scene_config(name, **overrides)
    gen = torch.Generator().manual_seed(seed)
    return cfg, init(gen, cfg, device=device)


def _disk(device: Device = "cuda", seed: int = 42, exact_ic: bool = False,
          **overrides) -> tuple[SphConfig, ParticleState]:
    if exact_ic:
        raise ValueError("exact_ic=True needs compat mode's bit-exact initial "
                         "state (compat/exact_ic.py), which is not ported to "
                         "the torch package yet")
    return _draw("disk", init_rotating_sphere, device, seed, overrides)


def _dam_break(device: Device = "cuda", seed: int = 7, **overrides
               ) -> tuple[SphConfig, ParticleState]:
    return _draw("dam_break", init_dam_break, device, seed, overrides)


def _splash(device: Device = "cuda", seed: int = 11, **overrides
            ) -> tuple[SphConfig, ParticleState]:
    return _draw("splash", init_splash, device, seed, overrides)


def _honey(device: Device = "cuda", seed: int = 42, **overrides
           ) -> tuple[SphConfig, ParticleState]:
    return _draw("honey", init_rotating_sphere, device, seed, overrides)


def _dam_break_10m(device: Device = "cuda", seed: int = 7, **overrides
                   ) -> tuple[SphConfig, ParticleState]:
    return _draw("dam_break_10m", init_dam_break, device, seed, overrides)


SCENES: dict[str, Callable[..., tuple[SphConfig, ParticleState]]] = {
    "disk": _disk,
    "dam_break": _dam_break,
    "splash": _splash,
    "honey": _honey,
    "dam_break_10m": _dam_break_10m,
}


def _known(name: str) -> None:
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; available: {sorted(SCENES)}")


def make_scene(name: str, **overrides) -> tuple[SphConfig, ParticleState]:
    """``make_scene("disk", device="cpu", seed=42, num_particles=...)``:
    ``device`` (default the card) and ``seed`` go to the initial conditions,
    ``exact_ic`` to the disk, every other keyword overrides a config field."""
    _known(name)
    return SCENES[name](**overrides)
