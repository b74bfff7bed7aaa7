"""The scene's constants, worked out from a configuration file's ``sph``
numbers as the project's specification defines them (float32-faithful:
each constant is rounded to float32 where the specification rounds it).

Plain Python and NumPy: the benchmark's initial conditions and its
reference read these, never the program's configuration object.
"""

from __future__ import annotations

import math

import numpy as np


def f32(x: float) -> float:
    """Round a Python float to float32 and back."""
    return float(np.float32(x))


def constants(sph: dict) -> dict:
    """The derived constants of one configuration's ``sph`` block."""
    h = f32(sph["h"])
    scale = f32(sph["sim_scale"])
    cell = f32(f32(sph["cell_size_factor"]) * h)
    dims = (sph["grid_nx"], sph["grid_ny"], sph["grid_nz"])
    h_s = f32(h * scale)
    box = tuple(f32(cell * d) for d in dims)
    soft = sph.get("softening")
    num_cells = dims[0] * dims[1] * dims[2]
    return {
        "n": int(sph["num_particles"]),
        "h": h,
        "h2": f32(h * h),
        "scale": scale,
        "scale2": f32(sph["sim_scale"] * sph["sim_scale"]),
        "h_s": h_s,
        "h_s2": f32(h_s ** 2),
        "poly6": f32(315.0 / (64.0 * math.pi * f32(h_s ** 9))),
        "visc_norm": f32(45.0 / (math.pi * f32(h_s ** 6))),
        "box": box,
        "center": tuple(f32(b * 0.5) for b in box),
        "rho0": f32(sph["rho0"]),
        "stiffness": f32(sph["stiffness"]),
        "viscosity": f32(sph["viscosity"]),
        "eps": f32(sph["pressure_softening"]),
        "damping": f32(sph["damping"]),
        "gravity": tuple(float(g) for g in sph["gravity"]),
        "gm": f32(-f32(sph["grav_constant"]) * f32(sph["central_mass"])),
        "softening": h_s if soft is None else f32(soft),
        "cfl": f32(sph["cfl_limit"]),
        "dt": f32(sph["dt"]),
        "pos_dt": f32(f32(sph["dt"]) * f32(1.0 / sph["sim_scale"])),
        "self_density": bool(sph["include_self_density"]),
        "reflect": sph["boundary"] == "reflect",
        "second_kick": sph["second_kick"],
        "particle_mass": float(sph["particle_mass"]),
        "steps": int(round(sph["total_time"] / sph["dt"])),
        # capped mode (K_c > 0): the kept set's rule, on the bins' grid
        "k_c": int(sph["capped_candidates"]),
        "capped_reweight": bool(sph["capped_reweight"]),
        "grid": dims,
        "inv_cell": f32(1.0 / cell),
        # the low bits an int32 spares beside the cell id
        "hash_bits": 31 - max((num_cells - 1).bit_length(), 1),
    }
