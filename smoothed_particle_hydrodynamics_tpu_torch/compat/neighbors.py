"""Quirk-faithful emulation of the reference's findNeighbors (counterpart of
``smoothed_particle_hydrodynamics_tpu/compat/neighbors.py``, whose docstring
lists each quirk with its line in the reference):

* the octant voxel table with the slot-3 overwrite (the z-face cell is never
  searched) and slot 4 read from uninitialised stack memory, emulated as
  always rejected (``slot4="skip"``) or as visited and empty (``"bump"``);
* the strict lower-boundary exclusion ``vxi > 0``;
* the int32-wrapping LCG start offset ``1664525*(i+a)+1013904223`` with C's
  truncated modulo; a negative offset puts the bucket's first 8-block out of
  bounds, which abandons the bucket;
* the parity-alternating direction, 8-wide blocks, the bucket abandoned at
  the first block that touches either end, the early exit once more than 24
  neighbors are stored (cap 32), and only the first four lanes of a block
  accepted (the reference's ``__m128`` bitmask over a float[8] buffer).

The JAX package vmaps a per-particle loop over slots and blocks; here the
slots loop on the host, each slot's blocks are tensor ops over all
particles and blocks at once (``find_neighbors_compat`` derives which
blocks the reference visits), with a per-particle ``done`` mask.  Bucket
contents are ascending particle ids (the stable cell-id sort of
``ops.grid``).  The squared distance is XLA:CPU's contracted form
(``physics.dot3``) and the stored distance a correctly rounded sqrt, so the
ids, distances and counts equal the JAX package's bit for bit on any
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import SphConfig
from ..ops.grid import build_grid, cell_coords
from ..ops.physics import dot3, fma32

K = 8  # the reference's SSE block width

# Voxel-offset table after the slot-3 overwrite; slot 4 (None) is
# uninitialised in the reference.  Entries are (x, y, z) multipliers on the
# per-particle octant signs.
_SLOTS = [
    (0, 0, 0),   # 0: own cell
    (1, 0, 0),   # 1: x face
    (0, 1, 0),   # 2: y face
    (1, 1, 0),   # 3: xy edge (overwrote the z face)
    None,        # 4: uninitialised stack values
    (1, 0, 1),   # 5: xz edge
    (0, 1, 1),   # 6: yz edge
    (1, 1, 1),   # 7: corner
]


class CompatNeighbors(NamedTuple):
    ids: torch.Tensor     # [N, 32] int32, valid in [0, count); padding = N
    dists: torch.Tensor   # [N, 32] float32 scaled distances (as stored)
    count: torch.Tensor   # [N] int32
    overflow_cells: torch.Tensor  # 0-d int32 (emulation exact only if 0)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _trunc_mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C's % (truncated toward zero; the sign follows the dividend), b > 0,
    as the JAX package's int32 ``a - sign(a) * (|a| // b) * b``, wraps
    included; int64 in and out."""
    a, b = a.long(), b.long()
    q = torch.div(wrap32(a.abs()), b, rounding_mode="floor")
    return wrap32(a - wrap32(wrap32(torch.sign(a) * q) * b))


def build_cell_table(cfg: SphConfig, pos: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense [C, cap] int32 table of ascending particle ids per cell (N
    where empty), the [C] counts and the cells over capacity (their rows
    beyond ``cell_capacity`` are dropped)."""
    n = pos.shape[0]
    g = build_grid(cfg, pos)
    counts = g.cell_end - g.cell_start
    cid = g.cell_ids.long()
    rank = torch.arange(n, device=pos.device) - g.cell_start.long()[cid]
    table = torch.full((cfg.num_cells, cfg.cell_capacity), n,
                       dtype=torch.int32, device=pos.device)
    keep = rank < cfg.cell_capacity
    table[cid[keep], rank[keep]] = g.order[keep].to(torch.int32)
    return table, counts, g.overflow_cells


def find_neighbors_compat(cfg: SphConfig, pos: torch.Tensor,
                          slot4: str = "skip") -> CompatNeighbors:
    """Emulate findNeighbors for every particle.

    ``slot4`` selects how the uninitialised voxel-table slot 4 behaves in
    the compiled binary being matched: "skip" (the garbage fails the bounds
    check, the bucket is never visited) or "bump" (it passes, so
    ``almost_a_random`` advances, but no neighbor is stored).

    A slot's blocks run one after another in the reference: a block is
    visited while no earlier block touched the bucket's ends or ended the
    bucket, and the count stayed at most 24.  The visited blocks are
    therefore a prefix, found here for all blocks at once: every block's
    hits as if visited, the prefix of blocks within the bucket, and the
    running count over it, which cuts the prefix after the first block that
    takes the count past 24.  The visited blocks' hits are appended in
    (block, lane) order."""
    n, dev = pos.shape[0], pos.device
    cap = cfg.cell_capacity
    table, counts, overflow = build_cell_table(cfg, pos)
    coords = cell_coords(cfg, pos).long()                  # [N, 3] clamped
    dims = torch.tensor([cfg.grid_nx, cfg.grid_ny, cfg.grid_nz], device=dev)
    blocks = -(-cap // K)
    max_store = cfg.max_neighbors
    slack = max_store + K                                  # last block's room

    pi = torch.arange(n, device=dev)
    # the octant signs; XLA:CPU fuses coord * cell into the subtraction
    orient = fma32(-coords.to(torch.float32),
                   torch.full_like(pos, cfg.cell_size), pos)
    sgn = torch.where(orient > cfg.h, 1, -1)               # [N, 3]
    direction = torch.where(pi % 2 == 1, -1, 1)
    # [blocks, K] offsets of each block's lanes from the start offset
    b_idx = torch.arange(blocks, device=dev)
    lane = torch.arange(K, device=dev)
    sse_lane = lane < K // 2

    ids = torch.full((n, slack), n, dtype=torch.int32, device=dev)
    dists = torch.zeros(n, slack, dtype=torch.float32, device=dev)
    cnt = torch.zeros(n, dtype=torch.int64, device=dev)
    almost = torch.zeros(n, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for mults in _SLOTS:
        if mults is None:                                  # slot 4 garbage
            if slot4 == "bump":
                almost = almost + (~done).long()
            continue
        v = coords + torch.tensor(mults, device=dev) * sgn
        in_bounds = ((v > 0) & (v < dims)).all(1)
        cid = ((v[:, 2] * cfg.grid_ny + v[:, 1]) * cfg.grid_nx
               + v[:, 0]).clamp(0, cfg.num_cells - 1)
        blen = counts.long()[cid]
        process = in_bounds & (blen > 0) & ~done

        lcg = wrap32(1664525 * (pi + almost) + 1013904223)
        almost = almost + process.long()
        offset = _trunc_mod(lcg, blen.clamp(min=1))
        max_steps = (blen + K - 1) // K
        # every block's lanes, hits as if the block were visited
        idxs = (offset[:, None, None] + lane
                + (K * b_idx)[:, None] * direction[:, None, None])
        oob = ((idxs < 0) | (idxs >= blen[:, None, None])).any(2)  # [N, B]
        cand = table[cid[:, None, None], idxs.clamp(0, cap - 1)]   # [N, B, K]
        diff = pos[:, None, None, :] - pos[cand.long().clamp(0, n - 1)]
        not_self = cand != pi[:, None, None]
        d2 = dot3(diff, diff) * not_self.to(torch.float32)
        hit = not_self & (d2 < cfg.h2) & (cand < n) & sse_lane
        # the blocks within the bucket, a prefix; the count over it; the
        # visited prefix ends after the block that takes it past 24
        within = (process[:, None] & ~oob & (b_idx < max_steps[:, None])
                  ).long().cumprod(1).bool()
        run = cnt[:, None] + (hit.sum(2) * within).cumsum(1)
        enough = run > max_store - K
        visited = within & ~F.pad(enough, (1, 0))[:, :-1]
        hit = (hit & visited[:, :, None]).view(n, -1)
        hi = hit.long()
        # compressed append in (block, lane) order
        tgt = torch.where(hit, cnt[:, None] + hi.cumsum(1) - hi, slack - 1)
        ids.scatter_(1, tgt, torch.where(hit, cand.view(n, -1),
                                         ids.gather(1, tgt)))
        d_store = torch.sqrt(d2.view(n, -1).double()).float() * cfg.sim_scale
        dists.scatter_(1, tgt, torch.where(hit, d_store,
                                           dists.gather(1, tgt)))
        cnt = cnt + hi.sum(1)
        done = done | (cnt > max_store - K)
    return CompatNeighbors(ids=ids[:, :max_store].contiguous(),
                           dists=dists[:, :max_store].contiguous(),
                           count=cnt.to(torch.int32),
                           overflow_cells=overflow)
