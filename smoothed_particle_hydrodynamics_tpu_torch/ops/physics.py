"""Pair physics, default (textbook Muller SPH) mode.

Counterpart of ``smoothed_particle_hydrodynamics_tpu/ops/physics.py``.  The
compat-mode quirks of the C++ reference are not ported yet; the functions
that would need them raise on ``cfg.compat``.  Scalar constants are the
config's float32-rounded values, so each tensor op rounds as the JAX
package's float32 op does.
"""

from __future__ import annotations

import torch

from ..config import SphConfig, _f32


def _no_compat(cfg: SphConfig) -> None:
    if cfg.compat:
        raise NotImplementedError("compat mode is not ported to the torch "
                                  "package yet")


def pressure_from_density(cfg: SphConfig, rho: torch.Tensor) -> torch.Tensor:
    """Stiff EoS p = k (rho - rho0)."""
    return (rho - _f32(cfg.rho0)) * _f32(cfg.stiffness)


def safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x where x > 0, else 1 (the kernels' ``rhoi_inv`` guard)."""
    return 1.0 / torch.where(x > 0.0, x, torch.ones_like(x))


def density_sum(cfg: SphConfig, m_j: torch.Tensor, d: torch.Tensor,
                mask: torch.Tensor, m_self: torch.Tensor | None = None
                ) -> torch.Tensor:
    """rho_i = sum_j m_j W_poly6(d_ij) over masked candidates (last axis)."""
    h2 = cfg.h_scaled2
    t = h2 - d * d
    w = cfg.poly6_norm * t * t * t
    w = torch.where(mask & (d <= cfg.h_scaled), w, torch.zeros_like(w))
    rho = (m_j * w).sum(-1)
    if cfg.include_self_density and m_self is not None:
        rho = rho + m_self * cfg.poly6_norm * h2 * h2 * h2
    return rho


def central_gravity(cfg: SphConfig, pos: torch.Tensor) -> torch.Tensor:
    """Point-mass acceleration a = -G M r_vec / (|r| + eps)^3 about the box
    centre.  pos: [..., 3] world coords -> [..., 3]."""
    center = torch.tensor(cfg.central_pos, dtype=torch.float32, device=pos.device)
    rel = (pos - center) * _f32(cfg.sim_scale)
    dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    base = dist + cfg.softening_eff
    denom = base * base * base
    gm = _f32(-_f32(cfg.grav_constant) * _f32(cfg.central_mass))
    return gm * rel / denom


def cfl_clamp(cfg: SphConfig, acc: torch.Tensor) -> torch.Tensor:
    """Clamp |a| to cfg.cfl_limit."""
    dot = (acc * acc).sum(-1, keepdim=True)
    limit = _f32(cfg.cfl_limit)
    scale = torch.where(dot > _f32(limit * limit), limit / torch.sqrt(dot),
                        torch.ones_like(dot))
    return acc * scale


def sph_acceleration(cfg: SphConfig, pos_i, vel_i, rho_i, pos_j, vel_j,
                     rho_j, m_j, d, mask) -> torch.Tensor:
    """Hydro acceleration (pressure gradient + viscosity) for particle(s) i
    against the candidate axis K: pos_j/vel_j [..., K, 3], rho_j/m_j/d/mask
    [..., K].  Gravity and the CFL clamp are the caller's."""
    _no_compat(cfg)
    h = cfg.h_scaled
    eps = _f32(cfg.pressure_softening)
    p_i = pressure_from_density(cfg, rho_i)
    p_j = pressure_from_density(cfg, rho_j)
    rho_j_inv = safe_inv(rho_j)
    rho_i_inv = safe_inv(rho_i)

    rel = (pos_i[..., None, :] - pos_j) * _f32(cfg.sim_scale)
    zero = torch.zeros_like(d)
    hd = torch.where(mask, h - d, zero)

    dir_term = rel / (d + eps)[..., None]
    pweight = (p_i * rho_i_inv * rho_i_inv)[..., None] + p_j * rho_j_inv * rho_j_inv
    center = torch.where(mask, hd * hd * m_j * pweight, zero)
    a_pressure = cfg.visc_lap_norm * (dir_term * center[..., None]).sum(-2)

    dv = vel_j - vel_i[..., None, :]
    vweight = torch.where(mask, hd * rho_j_inv * m_j * cfg.visc_lap_norm, zero)
    s = _f32(cfg.viscosity) * rho_i_inv
    a_visc = s[..., None] * (dv * vweight[..., None]).sum(-2)
    return a_visc + a_pressure
