"""Bit-exact reproduction of the reference's seeded initial conditions
(counterpart of ``smoothed_particle_hydrodynamics_tpu/compat/exact_ic.py``,
whose docstring derives each float operation from the reference binary).

``srand(42)``, rejection-sample positions uniformly in the box until inside
the radius-2 sphere at the box center, then give each particle a
near-Keplerian tangential velocity ``20 * (dist + h/2)^-1/2`` in the x-z
plane plus a uniform vertical jitter in [-0.25, 0.25).  Float semantics are
the binary's: float32 ``rand() / (float)RAND_MAX``, an FMA-contracted
distance test ``fmaf(dz, dz, fmaf(dx, dx, dy*dy)) > 4.0f``, one
``sincosf(atan2f(dz, dx))`` from the system libm (through ctypes; a
double-math fallback is within ~20 ulps of the velocities) and the speed in
double.  The state is computed on the host in numpy scalars and moved to
``device`` once.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math

import numpy as np
import torch

from ..config import SphConfig
from ..state import ParticleState
from .crand import CRand

_f32 = np.float32
_RAND_MAX_F = np.float32(2147483647)       # rounds to 2147483648.0f


def _libm_float_ops():
    """(fmaf, atan2f, sincosf) from the system libm, or None if unavailable."""
    try:
        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        libm.fmaf.restype = ctypes.c_float
        libm.fmaf.argtypes = [ctypes.c_float] * 3
        libm.atan2f.restype = ctypes.c_float
        libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
        libm.sincosf.restype = None
        libm.sincosf.argtypes = [ctypes.c_float,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_float)]

        def fmaf(a, b, c):
            return _f32(libm.fmaf(float(a), float(b), float(c)))

        def atan2f(y, x):
            return _f32(libm.atan2f(float(y), float(x)))

        sv, cv = ctypes.c_float(), ctypes.c_float()

        def sincosf(x):
            libm.sincosf(float(x), ctypes.byref(sv), ctypes.byref(cv))
            return _f32(sv.value), _f32(cv.value)

        fmaf(1.0, 1.0, 1.0)
        atan2f(1.0, 1.0)
        sincosf(1.0)
        return fmaf, atan2f, sincosf
    except (OSError, AttributeError):
        return None


def reference_initial_state(cfg: SphConfig, seed: int = 42,
                            device: torch.device | str = "cuda"
                            ) -> ParticleState:
    """Positions and velocities bit-identical to the reference's srand(42)
    init, on ``device`` (the card unless the caller names another)."""
    n = cfg.num_particles
    rng = CRand(seed, prefetch=max(1 << 20, n * 32))

    libm = _libm_float_ops()
    if libm is not None:
        fmaf, atan2f, sincosf = libm
    else:  # double-math fallback: positions still exact, velocities ~20 ulps
        def fmaf(a, b, c):
            return _f32(float(a) * float(b) + float(c))

        def atan2f(y, x):
            return _f32(math.atan2(float(y), float(x)))

        def sincosf(x):
            return _f32(math.sin(float(x))), _f32(math.cos(float(x)))

    scale_x = _f32(np.int32(cfg.grid_nx) * _f32(_f32(cfg.h) * _f32(2.0)))
    scale_y = _f32(np.int32(cfg.grid_ny) * _f32(_f32(cfg.h) * _f32(2.0)))
    scale_z = _f32(np.int32(cfg.grid_nz) * _f32(_f32(cfg.h) * _f32(2.0)))
    cx = _f32(scale_x * _f32(0.5))
    cy = _f32(scale_y * _f32(0.5))
    cz = _f32(scale_z * _f32(0.5))
    radius2 = _f32(4.0)
    # mHScaled * 0.5 with a double literal: double(0.1f) * 0.5
    h_half = float(_f32(_f32(cfg.h) * _f32(cfg.sim_scale))) * 0.5

    pos = np.zeros((n, 3), np.float32)
    vel = np.zeros((n, 3), np.float32)

    def unit() -> np.float32:
        return _f32(_f32(rng.next()) / _RAND_MAX_F)

    for i in range(n):
        while True:
            x = _f32(unit() * scale_x)
            y = _f32(unit() * scale_y)
            z = _f32(unit() * scale_z)
            if x == _f32(cfg.grid_nx):
                x = _f32(x - _f32(1e-5))   # dead in practice (x <= 6.4)
            if y == _f32(cfg.grid_ny):
                y = _f32(y - _f32(1e-5))
            if z == _f32(cfg.grid_nz):
                z = _f32(z - _f32(1e-5))
            dx = _f32(x - cx)
            dy = _f32(y - cy)
            dz = _f32(z - cz)
            d2 = fmaf(dz, dz, fmaf(dx, dx, _f32(dy * dy)))
            if not d2 > radius2:
                break
        pos[i, 0], pos[i, 1], pos[i, 2] = x, y, z

        dist = _f32(np.sqrt(d2))
        phi = atan2f(dz, dx)
        s, c = sincosf(phi)
        vt = 20.0 / math.sqrt(float(dist) + h_half)
        vel[i, 0] = _f32(vt * -float(s))
        vel[i, 2] = _f32(vt * float(c))
        vel[i, 1] = _f32(_f32(unit() * _f32(0.5)) - _f32(0.25))

    return ParticleState.from_arrays(torch.from_numpy(pos).to(device),
                                     torch.from_numpy(vel).to(device),
                                     cfg=cfg)
