"""Simulation configuration (pure Python; counterpart of the JAX package's
``smoothed_particle_hydrodynamics_tpu/config.py``).

The whole scene is one frozen dataclass with the same fields as the JAX
``SphConfig`` and the same float32-faithful derived constants, so a config
built here and one built there with the same fields give bit-equal
``poly6_norm``, ``h2``, ``cell_size`` and the rest.  Fields that only tune
the TPU kernels (``pallas_*`` window and block widths) keep their names and
their validation.  ``pallas_window_t``, ``pallas_block_t`` and
``pallas_groups`` shape no sublane sweep on one GPU (its kernels walk cell
bands); the lane layout's tables read ``pallas_window`` and
``pallas_block_rows``, and the slab engine rounds its capacities to
``pallas_block_t`` and requires ``pallas_window_t`` > 0.

Units follow the astrophysical fork: km/s, pc, M_sun, Myr.
"""

from __future__ import annotations

import dataclasses
import json
import math
import struct
from typing import Literal

BoundaryMode = Literal["none", "reflect"]
SecondKickMode = Literal["gravity", "none", "full"]
NeighborhoodMode = Literal["octant", "cell27"]


def _f32(x: float) -> float:
    """Round-trip a Python float through float32."""
    return struct.unpack("f", struct.pack("f", x))[0]


@dataclasses.dataclass(frozen=True)
class SphConfig:
    """Full scene + physics + solver configuration (defaults: the 32k
    rotating-disk reference scene)."""

    # --- scene / discretisation -------------------------------------------------
    num_particles: int = 32 * 1024
    h: float = 0.1                      # smoothing / interaction radius [pc]
    sim_scale: float = 1.0              # world->physics scale
    grid_nx: int = 32
    grid_ny: int = 32
    grid_nz: int = 32
    cell_size_factor: float = 2.0       # cell edge = cell_size_factor * h

    # --- time integration --------------------------------------------------------
    dt: float = 1e-3                    # [Myr]
    total_time: float = 1.0             # [Myr]

    # --- fluid physics ------------------------------------------------------------
    rho0: float = 0.1                   # rest density
    stiffness: float = 1e-3             # EoS k: p = k (rho - rho0)
    viscosity: float = 1e-2             # viscosity coefficient mu
    damping: float = 1e-3               # boundary reflection damping
    gravity: tuple[float, float, float] = (0.0, 0.0, 0.0)  # uniform gravity

    # --- central point mass ---------------------------------------------------------
    grav_constant: float = 4.3009e-3    # G in pc (km/s)^2 / M_sun
    central_mass: float = 1e5           # [M_sun]
    softening: float | None = None      # defaults to h*sim_scale

    # --- particle properties -------------------------------------------------------
    particle_mass: float = 1.0          # [M_sun] each

    # --- solver limits ---------------------------------------------------------------
    cfl_limit: float = 1e4              # acceleration magnitude clamp
    max_neighbors: int = 32             # per-particle neighbor cap (compat / capped)
    cell_capacity: int = 96             # max particles binned per grid cell
    range_slice: int = 96               # candidate slice per x-contiguous cell range

    # --- behaviour switches ---------------------------------------------------------
    compat: bool = False                # reproduce the C++ reference's quirks
    include_self_density: bool = False  # textbook SPH adds the self term
    boundary: BoundaryMode = "none"
    second_kick: SecondKickMode = "gravity"
    pressure_softening: float = 0.01    # +eps on |r_ij| in the spiky gradient
    neighborhood: NeighborhoodMode = "octant"

    # --- sweep tuning (names shared with the JAX package) -----------------------
    pallas_block_rows: int = 128        # lane layout: sorted rows per block
    pallas_window: int = 512            # lane layout: rows per window chunk (x128)
    pallas_interpret: bool = False      # JAX interpreter mode; unused here
    pallas_layout: str = "sublane"      # "sublane" (sweeps_t) or "lane" (sweeps_lane)
    pallas_window_t: int = 192          # rows per window chunk (multiple of 8)
    pallas_block_t: int = 128           # sorted particles per block (128/256/512)
    pallas_groups: int = 1              # lane groups: 1, 2 or 4 (exact mode)
    # --- capped candidates ("Subsets"; ops/sweeps_t.py) -----------------------
    capped_candidates: int = 0          # K_c kept candidates per cell (0 = exact)
    capped_reweight: bool = True        # kept masses * occupancy/kept
    capped_fused: bool = False          # sub-frame pre-pass + one fused sweep
    capped_sub_len: int = 0             # sub-frame rows (0 = num_particles)

    # ---------------------------------------------------------------------------
    # Derived constants (float32-faithful)
    # ---------------------------------------------------------------------------
    @property
    def h2(self) -> float:
        return _f32(_f32(self.h) ** 2)

    @property
    def cell_size(self) -> float:
        return _f32(_f32(self.cell_size_factor) * _f32(self.h))

    @property
    def inv_cell_size(self) -> float:
        return _f32(1.0 / self.cell_size)

    @property
    def h_scaled(self) -> float:
        return _f32(_f32(self.h) * _f32(self.sim_scale))

    @property
    def h_scaled2(self) -> float:
        return _f32(self.h_scaled ** 2)

    @property
    def h_scaled6(self) -> float:
        return _f32(self.h_scaled ** 6)

    @property
    def h_scaled9(self) -> float:
        return _f32(self.h_scaled ** 9)

    @property
    def box_max(self) -> tuple[float, float, float]:
        return (
            _f32(self.cell_size * self.grid_nx),
            _f32(self.cell_size * self.grid_ny),
            _f32(self.cell_size * self.grid_nz),
        )

    @property
    def central_pos(self) -> tuple[float, float, float]:
        mx, my, mz = self.box_max
        return (_f32(mx * 0.5), _f32(my * 0.5), _f32(mz * 0.5))

    @property
    def softening_eff(self) -> float:
        return self.h_scaled if self.softening is None else _f32(self.softening)

    @property
    def num_cells(self) -> int:
        return self.grid_nx * self.grid_ny * self.grid_nz

    @property
    def num_steps(self) -> int:
        return int(round(self.total_time / self.dt))

    @property
    def poly6_norm(self) -> float:
        return _f32(315.0 / (64.0 * math.pi * self.h_scaled9))

    @property
    def spiky_grad_norm(self) -> float:
        return _f32(-45.0 / (math.pi * self.h_scaled6))

    @property
    def visc_lap_norm(self) -> float:
        return _f32(45.0 / (math.pi * self.h_scaled6))

    # ---------------------------------------------------------------------------
    def replace(self, **kw) -> "SphConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SphConfig":
        d = json.loads(text)
        if isinstance(d.get("gravity"), list):
            d["gravity"] = tuple(d["gravity"])
        return cls(**d)

    def validate(self) -> None:
        if self.num_particles <= 0:
            raise ValueError("num_particles must be positive")
        if self.h <= 0 or self.dt <= 0:
            raise ValueError("h and dt must be positive")
        if self.cell_capacity < 1 or self.max_neighbors < 1:
            raise ValueError("capacities must be >= 1")
        if self.cell_size < self.h:
            raise ValueError("cell_size must cover the interaction radius h "
                             "(cell_size_factor >= 1)")
        if self.neighborhood == "octant" and self.cell_size < 2.0 * self.h:
            raise ValueError("octant stencil requires cell_size >= 2h; use cell27")
        if self.compat and self.cell_size_factor != 2.0:
            raise ValueError("compat mode requires the reference's 2h cells")
        if self.capped_candidates < 0:
            raise ValueError("capped_candidates must be >= 0 (0 = off)")
        if self.capped_sub_len < 0 or self.capped_sub_len % 128:
            raise ValueError("capped_sub_len must be a non-negative multiple "
                             "of 128 (0 = num_particles)")
        if self.capped_candidates and self.compat:
            raise ValueError("capped_candidates is the default-mode subsets "
                             "feature; compat mode has its own bit-faithful cap")
