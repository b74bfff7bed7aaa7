"""Loader for golden-state dumps of the compiled, unmodified reference
engine (counterpart of ``smoothed_particle_hydrodynamics_tpu/compat/
golden.py``).  ``tools/golden_main.cpp`` writes them; ``write_golden``
writes the same little-endian format:

    int32 N
    float mass[N], density[N], position[3N], velocity[3N], acceleration[3N]
    int32 neighborCount[N]
    uint32 neighborIds[N*32]
    float neighborDists[N*32]
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np
import torch


class GoldenState(NamedTuple):
    n: int
    mass: np.ndarray          # [N] f32
    density: np.ndarray       # [N] f32
    position: np.ndarray      # [N,3] f32
    velocity: np.ndarray      # [N,3] f32
    acceleration: np.ndarray  # [N,3] f32
    neighbor_count: np.ndarray  # [N] i32
    neighbor_ids: np.ndarray    # [N,32] u32 (stale beyond count)
    neighbor_dists: np.ndarray  # [N,32] f32


def load_golden(path: str, cap: int = 32) -> GoldenState:
    with open(path, "rb") as f:
        n = struct.unpack("<i", f.read(4))[0]

        def rd(cnt, dt):
            return np.frombuffer(f.read(cnt * np.dtype(dt).itemsize), dt).copy()

        mass = rd(n, np.float32)
        dens = rd(n, np.float32)
        pos = rd(3 * n, np.float32).reshape(n, 3)
        vel = rd(3 * n, np.float32).reshape(n, 3)
        acc = rd(3 * n, np.float32).reshape(n, 3)
        nc = rd(n, np.int32)
        nid = rd(n * cap, np.uint32).reshape(n, cap)
        nd = rd(n * cap, np.float32).reshape(n, cap)
    return GoldenState(n, mass, dens, pos, vel, acc, nc, nid, nd)


def write_golden(path: str, g: GoldenState) -> None:
    """Write ``g`` in ``tools/golden_main.cpp``'s dump format."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", g.n))
        for a, dt in ((g.mass, "<f4"), (g.density, "<f4"),
                      (g.position, "<f4"), (g.velocity, "<f4"),
                      (g.acceleration, "<f4"), (g.neighbor_count, "<i4"),
                      (g.neighbor_ids, "<u4"), (g.neighbor_dists, "<f4")):
            f.write(np.ascontiguousarray(a, dtype=dt).tobytes())


def golden_dir() -> str | None:
    """Locate generated golden dumps (``tools/golden_m4`` of the checkout)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cand = os.path.join(here, "tools", "golden_m4")
    return cand if os.path.isdir(cand) else None


def to_state(g: GoldenState, device: torch.device | str = "cuda"):
    """GoldenState -> ParticleState on ``device``."""
    from ..state import ParticleState

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return ParticleState(position=t(g.position), velocity=t(g.velocity),
                         mass=t(g.mass), density=t(g.density),
                         acceleration=t(g.acceleration),
                         neighbor_count=t(g.neighbor_count))
