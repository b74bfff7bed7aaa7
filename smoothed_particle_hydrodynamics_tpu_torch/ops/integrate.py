"""Leapfrog KDK, reflective boundary and energy tallies (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/integrate.py``).

The closing kick re-evaluates only the central point-mass gravity
(``second_kick="gravity"``) or nothing (``"none"``); ``"full"`` re-evaluates
the whole force and is applied by ``ops.step``.  In compat mode the tallies
are the reference's: at-rest particles are left out of both, the potential
divides by (d + eps)^3 (quirk 8) and |L| is 0, as the reference logs it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SphConfig, _f32
from ..state import ParticleState
from .physics import central_gravity


class EnergyTally(NamedTuple):
    kinetic: torch.Tensor
    potential: torch.Tensor
    angular_momentum: torch.Tensor
    l_vec: torch.Tensor          # [3] un-normed angular-momentum sum


def kdk_integrate(cfg: SphConfig, state: ParticleState,
                  acceleration: torch.Tensor
                  ) -> tuple[ParticleState, EnergyTally]:
    """One kick-drift-kick update; ``acceleration`` is the full (hydro +
    gravity, CFL-clamped) acceleration at the pre-step positions.  The tally
    is taken at the post-kick velocities and drifted positions."""
    dt = _f32(cfg.dt)
    pos_dt = _f32(dt * _f32(1.0 / cfg.sim_scale))

    v_half = state.velocity + acceleration * _f32(dt * 0.5)
    new_pos = state.position + v_half * pos_dt

    if cfg.second_kick == "gravity":
        new_vel = v_half + central_gravity(cfg, new_pos) * dt
    elif cfg.second_kick == "none":
        new_vel = v_half
    else:
        raise ValueError("second_kick='full' must be handled by the step "
                         "function (ops.step), which re-evaluates the force")

    if cfg.boundary == "reflect":
        new_pos, new_vel = reflect_boundary(cfg, state.position, new_pos, new_vel)

    tally = energy_tally(cfg, new_pos, new_vel, state.mass)
    new_state = state._replace(position=new_pos, velocity=new_vel,
                               acceleration=acceleration)
    return new_state, tally


def _rel(cfg: SphConfig, pos: torch.Tensor) -> torch.Tensor:
    center = torch.tensor(cfg.central_pos, dtype=torch.float32, device=pos.device)
    return (pos - center) * _f32(cfg.sim_scale)


def angular_momentum_vec(cfg: SphConfig, pos: torch.Tensor, vel: torch.Tensor,
                         mass: torch.Tensor) -> torch.Tensor:
    """[3] vector L = sum_i m_i (r_i - c) x v_i about the central mass."""
    return (mass[:, None] * torch.linalg.cross(_rel(cfg, pos), vel)).sum(0)


def energy_tally(cfg: SphConfig, pos: torch.Tensor, vel: torch.Tensor,
                 mass: torch.Tensor) -> EnergyTally:
    """KE / PE / |L| as one stacked [N, 5] column sum.

    Only non-finite velocities are masked from KE; PE is not velocity-gated,
    so NaN positions surface as NaN PE.  With no central mass (G*M == 0) the
    PE pass is skipped and a ``0 * x`` canary keeps non-finite positions
    visible in PE.  Compat mode: the reference's tallies (module docstring).
    """
    rel = _rel(cfg, pos)
    v2 = (vel * vel).sum(-1)
    if cfg.compat:
        return _compat_tally(cfg, rel, v2, mass)
    ke_i = torch.where(torch.isfinite(v2), 0.5 * mass * v2, torch.zeros_like(v2))
    if float(cfg.grav_constant) * float(cfg.central_mass) == 0.0:
        pe_i = (rel[:, 0] + rel[:, 1] + rel[:, 2]) * 0.0
    else:
        gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
        dist = torch.sqrt((rel * rel).sum(-1))
        pe_i = gm * mass / (dist + cfg.softening_eff)
    l_i = mass[:, None] * torch.linalg.cross(rel, vel)
    s = torch.cat([ke_i[:, None], pe_i[:, None], l_i], dim=1).sum(0)
    l_vec = s[2:5]
    return EnergyTally(s[0], -s[1], torch.linalg.norm(l_vec), l_vec)


def _compat_tally(cfg: SphConfig, rel: torch.Tensor, v2: torch.Tensor,
                  mass: torch.Tensor) -> EnergyTally:
    """The reference's tallies: its ``dot > 0`` guard leaves at-rest
    particles out of KE and PE, PE divides by (d + eps)^3, |L| is 0."""
    gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
    base = torch.linalg.norm(rel, dim=-1) + cfg.softening_eff
    ok = v2 > 0.0
    zero = torch.zeros_like(v2)
    ke = torch.where(ok, 0.5 * mass * v2, zero).sum()
    pe = -torch.where(ok, gm * mass / (base * base * base), zero).sum()
    zero3 = torch.zeros(3, dtype=torch.float32, device=v2.device)
    return EnergyTally(ke, pe, zero3[0], zero3)


def reflect_boundary(cfg: SphConfig, old_pos: torch.Tensor,
                     new_pos: torch.Tensor, new_vel: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflect particles off the box walls with damping: a crossing particle
    is placed at the wall intersection plus the reflected, damped remainder
    of its displacement, and its velocity flips sign."""
    box = torch.tensor(cfg.box_max, dtype=torch.float32, device=new_pos.device)
    zero = torch.zeros_like(new_pos)

    below = new_pos < 0.0
    above = new_pos > box
    crossed = below | above

    disp = new_pos - old_pos
    safe_disp = torch.where(disp == 0.0, torch.full_like(disp, 1e-30), disp)
    inv_disp = 1.0 / safe_disp
    f_low = -old_pos * inv_disp
    f_high = (box - old_pos) * inv_disp
    f_hit = torch.where(below, f_low, torch.where(above, f_high, zero))

    reflected_vel = torch.where(crossed, -new_vel, new_vel)
    intersection = old_pos + disp * f_hit
    remaining = torch.clamp(1.0 - f_hit, min=0.0)
    bounced = intersection - disp * (remaining * _f32(cfg.damping))

    out_pos = torch.where(crossed, bounced, new_pos)
    out_pos = torch.minimum(torch.clamp(out_pos, min=0.0), box)
    return out_pos, reflected_vel
