"""Uniform-grid binning helpers (counterpart of
``smoothed_particle_hydrodynamics_tpu/ops/grid.py``).

Linear cell id ``(z*ny + y)*nx + x`` with positions clamped into the grid.
Cells adjacent in x are adjacent in sorted order, so each (dy, dz) stencil
rod of the 27-cell neighborhood is one contiguous row range of the sorted
frame: the property the sweeps' cell bands and window tables are built on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SphConfig

# The 9 (dy, dz) stencil rods of the 27-cell neighborhood; rod r's linear-id
# offset is (dz*ny + dy)*nx (``rod_deltas``).
RODS = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
# Cell id of rows that hold no particle of the grid (a capped sub frame's
# unkept tail, the lane field tables' pad rows): no rod band
# [cid_i + delta - 1, cid_i + delta + 1] reaches it, and cell ids stay below
# 2^30 so no difference to it overflows past the band either.
NO_CELL = -(1 << 30)


def rod_deltas(cfg: SphConfig) -> list[int]:
    return [(dz * cfg.grid_ny + dy) * cfg.grid_nx for dy, dz in RODS]


class Grid(NamedTuple):
    """Sorted-order grid view of a particle set."""

    order: torch.Tensor           # [N] i64: sorted row -> original index
    cell_ids: torch.Tensor        # [N] i32: cell id per sorted particle
    cell_start: torch.Tensor      # [C] i32: first sorted row of each cell
    cell_end: torch.Tensor        # [C] i32: one past the last sorted row
    coords: torch.Tensor          # [N, 3] i32: cell coords per sorted row
    overflow_cells: torch.Tensor  # i32: cells holding > cfg.cell_capacity


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


def build_grid(cfg: SphConfig, pos: torch.Tensor) -> Grid:
    """Stable sort by cell id (cell members keep ascending index order),
    per-cell [start, end) offsets from a bincount + cumsum, and the count of
    cells over ``cell_capacity`` (counted, never a failure)."""
    coords = cell_coords(cfg, pos)
    cid = linear_cell_id(cfg, coords)
    cid_sorted, order = torch.sort(cid, stable=True)
    counts = torch.bincount(cid, minlength=cfg.num_cells).to(torch.int32)
    cell_end = counts.cumsum(0, dtype=torch.int32)
    return Grid(order=order, cell_ids=cid_sorted, cell_start=cell_end - counts,
                cell_end=cell_end, coords=coords[order],
                overflow_cells=(counts > cfg.cell_capacity).sum(
                    dtype=torch.int32))


def unsort(order: torch.Tensor, sorted_values: torch.Tensor) -> torch.Tensor:
    """Scatter sorted-order values back to the original particle order
    (``out[order] = v``; ``order`` is a permutation, so every row is written
    once and the result is deterministic)."""
    out = torch.empty_like(sorted_values)
    out[order] = sorted_values
    return out


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
