"""Particle state and per-step diagnostics as NamedTuples of tensors.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/state.py``: the same
fields, ``[N, 3]`` float32 for vectors and ``[N]`` for scalars.
``state_from_numpy`` / ``state_to_numpy`` carry a state across the two
packages bit for bit (the JAX side's ``ParticleState.to_numpy()`` dict).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SphConfig


class ParticleState(NamedTuple):
    """Structure-of-arrays particle fields."""

    position: torch.Tensor        # [N, 3] float32, world units
    velocity: torch.Tensor        # [N, 3] float32, km/s
    mass: torch.Tensor            # [N]    float32, M_sun
    density: torch.Tensor         # [N]    float32 (derived each step)
    acceleration: torch.Tensor    # [N, 3] float32 (derived each step)
    neighbor_count: torch.Tensor  # [N]    int32   (derived each step)

    @property
    def n(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def from_arrays(position: torch.Tensor, velocity: torch.Tensor,
                    mass: torch.Tensor | None = None,
                    cfg: SphConfig | None = None) -> "ParticleState":
        position = position.to(torch.float32)
        velocity = velocity.to(torch.float32)
        n, dev = position.shape[0], position.device
        if mass is None:
            m = cfg.particle_mass if cfg is not None else 1.0
            mass = torch.full((n,), m, dtype=torch.float32, device=dev)
        return ParticleState(
            position=position,
            velocity=velocity,
            mass=mass.to(torch.float32),
            density=torch.zeros(n, dtype=torch.float32, device=dev),
            acceleration=torch.zeros(n, 3, dtype=torch.float32, device=dev),
            neighbor_count=torch.zeros(n, dtype=torch.int32, device=dev),
        )


_DTYPES = {"position": torch.float32, "velocity": torch.float32,
           "mass": torch.float32, "density": torch.float32,
           "acceleration": torch.float32, "neighbor_count": torch.int32}


def state_from_numpy(d: dict[str, np.ndarray],
                     device: torch.device | str = "cuda") -> ParticleState:
    """A ``ParticleState.to_numpy()`` dict (either package) -> tensors on
    ``device`` (the card unless the caller asks for the CPU, as every entry
    point of the package); float32/int32 values are carried over
    unchanged."""
    return ParticleState(**{
        k: torch.tensor(np.asarray(d[k]), dtype=dt, device=device)
        for k, dt in _DTYPES.items()})


def state_to_numpy(s: ParticleState) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in s._asdict().items()}


class StepDiagnostics(NamedTuple):
    """Per-step scalar diagnostics (0-d tensors, left on the device)."""

    kinetic_energy: torch.Tensor     # f32
    potential_energy: torch.Tensor   # f32
    angular_momentum: torch.Tensor   # f32 |L| about the central mass
    neighbor_mean: torch.Tensor      # f32
    neighbor_max: torch.Tensor       # i32
    neighbor_min: torch.Tensor       # i32
    overflow_cells: torch.Tensor     # i32: cells over capacity
    truncated_ranges: torch.Tensor   # i32: candidate windows cut
    halo_dropped: torch.Tensor       # i32: sharded halo path
    migration_dropped: torch.Tensor  # i32: slab path


def make_step_diagnostics(tally, neighbor_count: torch.Tensor,
                          overflow_cells: torch.Tensor,
                          truncated_ranges: torch.Tensor | None = None
                          ) -> StepDiagnostics:
    """Assemble the per-step record from an energy tally, the neighbor
    counts, the backend's count of cells over ``cell_capacity`` and the
    candidate ranges it cut (None = 0).  The halo and migration counters are
    0: the single-device path has neither."""
    nc = neighbor_count
    zero = torch.zeros((), dtype=torch.int32, device=nc.device)
    return StepDiagnostics(
        kinetic_energy=tally.kinetic,
        potential_energy=tally.potential,
        angular_momentum=tally.angular_momentum,
        neighbor_mean=nc.to(torch.float32).mean(),
        neighbor_max=nc.max(),
        neighbor_min=nc.min(),
        overflow_cells=overflow_cells,
        truncated_ranges=zero if truncated_ranges is None else truncated_ranges,
        halo_dropped=zero,
        migration_dropped=zero,
    )


def stack_diagnostics(diags: list[StepDiagnostics]) -> StepDiagnostics:
    """Per-step records -> one record of [steps] tensors."""
    return StepDiagnostics(*(torch.stack(f) for f in zip(*diags)))
