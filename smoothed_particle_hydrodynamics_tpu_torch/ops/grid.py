"""Uniform-grid binning helpers (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/grid.py``).

Linear cell id ``(z*ny + y)*nx + x`` with positions clamped into the grid.
Cells adjacent in x are adjacent in sorted order, so each (dy, dz) stencil
rod of the 27-cell neighborhood is one contiguous row range of the sorted
frame: the property the sweeps' window tables are built on.
"""

from __future__ import annotations

import torch

from ..config import SphConfig


def cell_coords(cfg: SphConfig, pos: torch.Tensor) -> torch.Tensor:
    """floor(pos / cell) clamped into the grid. [N, 3] int32."""
    v = torch.floor(pos * cfg.inv_cell_size).to(torch.int32)
    hi = torch.tensor([cfg.grid_nx - 1, cfg.grid_ny - 1, cfg.grid_nz - 1],
                      dtype=torch.int32, device=pos.device)
    return torch.minimum(torch.clamp(v, min=0), hi)


def linear_cell_id(cfg: SphConfig, coords: torch.Tensor) -> torch.Tensor:
    """(z*ny + y)*nx + x, int32."""
    return ((coords[..., 2] * cfg.grid_ny + coords[..., 1]) * cfg.grid_nx
            + coords[..., 0])


def inverse_order(order: torch.Tensor) -> torch.Tensor:
    """Inverse of a permutation: ``inv[order[i]] = i``."""
    inv = torch.empty_like(order)
    inv[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                     device=order.device)
    return inv


def unsort_stacked(inv_order: torch.Tensor, columns: list[torch.Tensor]
                   ) -> list[torch.Tensor]:
    """Un-permute several [N] / [N, k] tensors by the inverse order (one row
    gather each; the JAX package stacks them because wide gathers are
    cheaper on the TPU)."""
    idx = inv_order.long()
    return [c[idx] for c in columns]
