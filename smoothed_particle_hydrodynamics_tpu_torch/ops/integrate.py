"""Leapfrog KDK, reflective boundary and energy tallies (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/integrate.py``).

The closing kick re-evaluates only the central point-mass gravity
(``second_kick="gravity"``) or nothing (``"none"``); ``"full"`` re-evaluates
the whole force and is applied by ``ops.step``.  In compat mode the tallies
are the reference's: at-rest particles are left out of both, the potential
divides by (d + eps)^3 (quirk 8) and |L| is 0, as the reference logs it.

``kdk_integrate`` given CPU tensors computes with its plain PyTorch twin
``kdk_integrate_plain`` (the kick, the drift, ``reflect_boundary`` and
``energy_tally``); given CUDA tensors it launches ``integrate_t``, one pass
of the CUDA kernel ``integrate_t`` (``csrc/integrate_t.cu``, built from
source on first use) and the one-block sum of its tally partials, or
raises; any other device raises.  The kernel's positions and velocities
equal the twin's on the card bit for bit; its tally sums in float64, the
twin's in float32.  ``integrate_t.launches`` counts its calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..config import SphConfig, _f32
from ..state import ParticleState
from ..utils import build
from .launch import check as _check
from .launch import raise_on as _raise_on
from .launch import stream as _stream
from .launch import use_plain as _use_plain
from .physics import central_gravity

# Threads a block, blocks an SM of the persistent grid, and tally partials a
# block (csrc/integrate_t.cu: kThreads, the launch bounds, kTerms).
THREADS, BLOCKS_PER_SM, TERMS = 256, 4, 5
# The kernel's template flags (csrc/integrate_t.cu: Kick, Tally).
KICK = {"none": 0, "gravity": 1}
TALLY_CANARY, TALLY_POTENTIAL, TALLY_COMPAT = 0, 1, 2


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
    is taken at the post-kick velocities and drifted positions.  The twin
    on the CPU, the kernel on the card."""
    if _use_plain(state.position):
        return kdk_integrate_plain(cfg, state, acceleration)
    return integrate_t(cfg, state, acceleration)


def _tally_form(cfg: SphConfig) -> int:
    if cfg.compat:
        return TALLY_COMPAT
    if float(cfg.grav_constant) * float(cfg.central_mass) == 0.0:
        return TALLY_CANARY
    return TALLY_POTENTIAL


@functools.cache
def _kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/integrate_t.cu``."""
    lib = build.load_library("integrate_t")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sph_integrate_t.argtypes = ([p] * 8 + [i] * 5 + [f] * 8
                                    + [ctypes.POINTER(f)] * 2 + [p])
    lib.sph_integrate_t.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _grid_cap(index: int) -> int:
    """Blocks of the persistent grid on card ``index``."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        index).multi_processor_count


def grid_blocks(n: int, cap: int) -> int:
    """Blocks of the pass over ``n`` rows: one a row's block of ``THREADS``
    up to ``cap``, each walking the rows in a grid-stride loop; the tally
    has that many partials a term."""
    return min(-(-n // THREADS), cap)


def _launch(cfg: SphConfig, state: ParticleState, acceleration: torch.Tensor,
            pos: torch.Tensor, vel: torch.Tensor, partials: torch.Tensor,
            tally: torch.Tensor, blocks: int) -> None:
    """Launch the pass over the state's rows into ``pos``, ``vel`` and the
    [blocks, TERMS] float64 ``partials``, and the sum of the partials into
    ``tally`` = [KE, PE, Lx, Ly, Lz, |L|], on the current stream."""
    dt = _f32(cfg.dt)
    f3 = ctypes.c_float * 3
    gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
    lib = _kernels()
    err = lib.sph_integrate_t(
        state.position.data_ptr(), state.velocity.data_ptr(),
        acceleration.data_ptr(), state.mass.data_ptr(), pos.data_ptr(),
        vel.data_ptr(), partials.data_ptr(), tally.data_ptr(), state.n,
        blocks, KICK[cfg.second_kick], int(cfg.boundary == "reflect"),
        _tally_form(cfg), _f32(dt * 0.5),
        _f32(dt * _f32(1.0 / cfg.sim_scale)), dt, _f32(cfg.sim_scale),
        _f32(cfg.damping), -gm, gm, cfg.softening_eff, f3(*cfg.central_pos), f3(*cfg.box_max),
        _stream(pos.device))
    _raise_on(lib, err, "integrate_t")


def integrate_t(cfg: SphConfig, state: ParticleState,
                acceleration: torch.Tensor
                ) -> tuple[ParticleState, EnergyTally]:
    """``kdk_integrate`` on the card: one pass of the kernel over the rows
    and the one-block sum of its tally partials (two launches, no sync),
    the kernel's arguments checked first.  No rows launch nothing and give
    zero tallies."""
    if cfg.second_kick not in KICK:
        raise ValueError("second_kick='full' must be handled by the step "
                         "function (ops.step), which re-evaluates the force")
    n, dev = state.n, state.position.device
    _check(dev, position=(state.position, torch.float32, (n, 3)),
           velocity=(state.velocity, torch.float32, (n, 3)),
           acceleration=(acceleration, torch.float32, (n, 3)),
           mass=(state.mass, torch.float32, (n,)))
    pos = torch.empty(n, 3, dtype=torch.float32, device=dev)
    vel = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n:
        tally = torch.empty(6, dtype=torch.float32, device=dev)
        blocks = grid_blocks(n, _grid_cap(dev.index or 0))
        partials = torch.empty(blocks * TERMS, dtype=torch.float64,
                               device=dev)
        _launch(cfg, state, acceleration, pos, vel, partials, tally, blocks)
        integrate_t.launches += 1
    else:
        tally = torch.zeros(6, dtype=torch.float32, device=dev)
    new_state = state._replace(position=pos, velocity=vel,
                               acceleration=acceleration)
    ke, pe, _, _, _, l_norm = tally.unbind()
    return new_state, EnergyTally(ke, pe, l_norm, tally[2:5])


WRAPPERS = (integrate_t,)
for _w in WRAPPERS:
    _w.launches = 0


def kdk_integrate_plain(cfg: SphConfig, state: ParticleState,
                        acceleration: torch.Tensor
                        ) -> tuple[ParticleState, EnergyTally]:
    """``kdk_integrate``'s twin: the update as PyTorch ops."""
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


def tally_terms(cfg: SphConfig, pos: torch.Tensor, vel: torch.Tensor,
                mass: torch.Tensor) -> torch.Tensor:
    """[N, 5] float32 per-particle terms the tally sums: KE, PE (the
    positive G M m / (d + eps), or the canary), L_x, L_y, L_z; in compat
    mode KE, PE and three zero columns."""
    rel = _rel(cfg, pos)
    v2 = (vel * vel).sum(-1)
    if cfg.compat:
        ke_i, pe_i = _compat_terms(cfg, rel, v2, mass)
        zero = torch.zeros_like(v2)
        return torch.stack([ke_i, pe_i, zero, zero, zero], dim=1)
    ke_i = torch.where(torch.isfinite(v2), 0.5 * mass * v2, torch.zeros_like(v2))
    if float(cfg.grav_constant) * float(cfg.central_mass) == 0.0:
        pe_i = (rel[:, 0] + rel[:, 1] + rel[:, 2]) * 0.0
    else:
        gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
        dist = torch.sqrt((rel * rel).sum(-1))
        pe_i = gm * mass / (dist + cfg.softening_eff)
    l_i = mass[:, None] * torch.linalg.cross(rel, vel)
    return torch.cat([ke_i[:, None], pe_i[:, None], l_i], dim=1)


def energy_tally(cfg: SphConfig, pos: torch.Tensor, vel: torch.Tensor,
                 mass: torch.Tensor) -> EnergyTally:
    """KE / PE / |L| as one stacked [N, 5] column sum of ``tally_terms``.

    Only non-finite velocities are masked from KE; PE is not velocity-gated,
    so NaN positions surface as NaN PE.  With no central mass (G*M == 0) the
    PE pass is skipped and a ``0 * x`` canary keeps non-finite positions
    visible in PE.  Compat mode: the reference's tallies (module docstring),
    each summed alone.
    """
    if cfg.compat:
        ke_i, pe_i = _compat_terms(cfg, _rel(cfg, pos), (vel * vel).sum(-1),
                                   mass)
        zero3 = torch.zeros(3, dtype=torch.float32, device=vel.device)
        return EnergyTally(ke_i.sum(), -pe_i.sum(), zero3[0], zero3)
    s = tally_terms(cfg, pos, vel, mass).sum(0)
    l_vec = s[2:5]
    return EnergyTally(s[0], -s[1], torch.linalg.norm(l_vec), l_vec)


def _compat_terms(cfg: SphConfig, rel: torch.Tensor, v2: torch.Tensor,
                  mass: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's tally terms: its ``dot > 0`` guard leaves at-rest
    particles out of KE and PE, PE divides by (d + eps)^3."""
    gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
    base = torch.linalg.norm(rel, dim=-1) + cfg.softening_eff
    ok = v2 > 0.0
    zero = torch.zeros_like(v2)
    return (torch.where(ok, 0.5 * mass * v2, zero),
            torch.where(ok, gm * mass / (base * base * base), zero))


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
