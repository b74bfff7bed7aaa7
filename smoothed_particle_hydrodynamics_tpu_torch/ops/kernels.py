"""SPH smoothing kernels (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/kernels.py``): each a pure
elementwise function of the scaled pair distance ``d``, 0 outside the
support radius h.  The sweeps inline the same polynomials; these are the
reference forms the tests hold them to.
"""

from __future__ import annotations

import torch

from ..config import SphConfig


def poly6(cfg: SphConfig, d: torch.Tensor) -> torch.Tensor:
    """W_poly6(d) = 315/(64 pi h^9) * (h^2 - d^2)^3 for d <= h, else 0."""
    t = cfg.h_scaled2 - d * d
    w = cfg.poly6_norm * t * t * t
    return torch.where(d <= cfg.h_scaled, w, torch.zeros_like(w))


def spiky_grad_magnitude(cfg: SphConfig, d: torch.Tensor) -> torch.Tensor:
    """|grad W_spiky|(d) = 45/(pi h^6) * (h - d)^2 for d <= h, else 0 (the
    positive magnitude; callers apply direction and sign)."""
    t = cfg.h_scaled - d
    w = cfg.visc_lap_norm * t * t
    return torch.where(d <= cfg.h_scaled, w, torch.zeros_like(w))


def visc_laplacian(cfg: SphConfig, d: torch.Tensor) -> torch.Tensor:
    """lap W_visc(d) = 45/(pi h^6) * (h - d) for d <= h, else 0."""
    w = cfg.visc_lap_norm * (cfg.h_scaled - d)
    return torch.where(d <= cfg.h_scaled, w, torch.zeros_like(w))


def poly6_self(cfg: SphConfig) -> float:
    """W_poly6(0): the self-contribution the reference omits."""
    return float(cfg.poly6_norm) * float(cfg.h_scaled2) ** 3
