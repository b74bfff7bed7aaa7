"""The plain reference: one step of the specification from a state.

From positions, velocities and masses in one particle order, ``step``
works out every particle's neighbor count, density and acceleration and
the state one kick-drift-kick step later, in that order.  It finds the
pairs within h on a uniform grid of its own (cells of edge at least h, so
every pair lies in one of the 27 cells around a particle), walks each
cell row by row, and sums with the specification's equations: Muller SPH,
the poly6 density with its self term, the symmetric spiky pressure term
and the viscosity Laplacian, uniform and point-mass gravity, the CFL
clamp, leapfrog KDK and the damped reflecting box.

Plain PyTorch on any device, in ``dtype`` (float32 as the configuration
states; bfloat16 for the control).  It imports nothing of the program and
takes no table, order or constant that the program made: the constants
come from ``spec.constants`` of the configuration file's numbers.
``d^2`` is formed as ``(dx*dx + dy*dy) + dz*dz``, one rounding per
operation, as the specification's float32 arithmetic does, so the pair
test ``d^2 < h^2`` decides each pair on the same bits.

Capped mode (``capped_candidates`` K_c > 0, the "Subsets" rule): every
particle is a self row, but the candidates of its sums are only the kept
particles, at most K_c of each cell of the step's bins (``kept_set``).
Which are kept follows from the bins alone: the positions they were built
from and each particle's row in the frame they sorted.  Like the state a
step starts from, they are the program's state, which the caller hands
over; the kept set, the weights and the sums are worked out here.  A
particle's self term keeps its own mass; a candidate's mass
is scaled by occupancy / kept when ``capped_reweight`` is set; the force
reads each candidate's own density.  The program finds a step's pairs
through its frozen bins and its bounded sub frame; here they are every kept
particle within h at the step's positions.  So the one departure: no row
bound (``capped_sub_len``).  Kept rows beyond it are the program's counted
loss (a failed step), and read here as count differences.
"""

from __future__ import annotations

import torch

# neighbor cells, (dx, dy, dz) each in {-1, 0, 1}
OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
# pair elements per chunk ([rows, cell rows] tensors), bounding its memory
PAIR_BUDGET = 1 << 24


class _Grid:
    """Particles sorted by cell of a grid with edges of at least h, and
    the candidates of their sums by cell: every particle, or with ``kept``
    ([N] bool, the callers' order) the kept ones."""

    def __init__(self, c: dict, pos: torch.Tensor,
                 kept: torch.Tensor | None = None):
        dev = pos.device
        # a margin over h: a pair within h never spans two cell edges
        self.dims = [max(int(b / (c["h"] * (1 + 1e-6))), 1) for b in c["box"]]
        edge = torch.tensor([b / d for b, d in zip(c["box"], self.dims)],
                            dtype=torch.float64, device=dev)
        hi = torch.tensor(self.dims, device=dev) - 1
        coords = torch.floor(pos.double() / edge).long()
        coords = torch.minimum(coords.clamp(min=0), hi)
        cid = self._cid(coords)
        self.order = torch.sort(cid, stable=True).indices
        self.coords = coords[self.order]
        # the candidates' rows of the sorted frame (None: every row)
        self.cand = None
        if kept is not None:
            self.cand = torch.nonzero(kept[self.order]).squeeze(1)
            cid = cid[kept]
        ncells = self.dims[0] * self.dims[1] * self.dims[2]
        counts = torch.bincount(cid, minlength=ncells)
        self.end = counts.cumsum(0)
        self.start = self.end - counts
        self.most = int(counts.max())

    def _cid(self, coords: torch.Tensor) -> torch.Tensor:
        nx, ny, _ = self.dims
        return (coords[..., 2] * ny + coords[..., 1]) * nx + coords[..., 0]

    def chunks(self):
        """Row ranges [lo, hi) of the sorted frame, each within the pair
        budget at the fullest cell."""
        n = self.order.shape[0]
        rows = max(PAIR_BUDGET // max(self.most, 1), 1)
        for lo in range(0, n, rows):
            yield lo, min(n, lo + rows)

    def pairs(self, xyz, lo: int, hi: int, h2: float):
        """For self rows [lo, hi) of the sorted frame and each neighbor
        cell: (rows [R, L] of the sorted frame of the cell's candidates,
        mask of the pairs within h, dx, dy, dz, d^2), each [R, L], the
        offsets candidate minus self."""
        dev = xyz[0].device
        own = torch.arange(lo, hi, device=dev)
        ci = self.coords[lo:hi]
        dims = torch.tensor(self.dims, device=dev)
        xi = [x[lo:hi, None] for x in xyz]
        for off in OFFSETS:
            nc = ci + torch.tensor(off, device=dev)
            inside = ((nc >= 0) & (nc < dims)).all(1)
            cell = self._cid(torch.minimum(nc.clamp(min=0), dims - 1))
            a = torch.where(inside, self.start[cell], 0)
            e = torch.where(inside, self.end[cell], 0)
            width = int((e - a).max())
            if width == 0:
                continue
            rows = a[:, None] + torch.arange(width, device=dev)
            valid = rows < e[:, None]
            rows = torch.where(valid, rows, 0)
            if self.cand is not None:
                rows = self.cand[rows]
            dx, dy, dz = (x[rows] - s for x, s in zip(xyz, xi))
            d2 = dx * dx + dy * dy + dz * dz
            mask = valid & (rows != own[:, None]) & (d2 < h2)
            yield rows, mask, dx, dy, dz, d2


def _central_gravity(c: dict, pos: torch.Tensor) -> torch.Tensor:
    center = torch.tensor(c["center"], dtype=pos.dtype, device=pos.device)
    rel = (pos - center) * c["scale"]
    dist = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    base = dist + c["softening"]
    return c["gm"] * rel / (base * base * base)


def _reflect(c: dict, old_pos, new_pos, new_vel):
    """Damped reflection off the box walls (the specification's
    ``reflect_boundary``)."""
    box = torch.tensor(c["box"], dtype=new_pos.dtype, device=new_pos.device)
    zero = torch.zeros_like(new_pos)
    below = new_pos < 0.0
    above = new_pos > box
    crossed = below | above
    disp = new_pos - old_pos
    safe = torch.where(disp == 0.0, torch.full_like(disp, 1e-30), disp)
    inv = 1.0 / safe
    f_hit = torch.where(below, -old_pos * inv,
                        torch.where(above, (box - old_pos) * inv, zero))
    vel = torch.where(crossed, -new_vel, new_vel)
    hit = old_pos + disp * f_hit
    remaining = torch.clamp(1.0 - f_hit, min=0.0)
    bounced = hit - disp * (remaining * c["damping"])
    pos = torch.where(crossed, bounced, new_pos)
    return torch.minimum(torch.clamp(pos, min=0.0), box), vel


def kept_set(c: dict, bin_pos: torch.Tensor, bin_row: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Capped mode: (kept [N] bool, weight [N] float32) in the callers'
    order, from the step's bins: ``bin_pos`` [N, 3] float32, the positions
    they were built from, and ``bin_row`` [N], each particle's row in the
    frame they sorted.

    A particle's cell is floor(x * f32(1/cell)) in float32 per axis,
    clamped into the grid, and (z*ny + y)*nx + x; its key the 31-bit Knuth
    hash of its row, (row * 2654435769) mod 2^31.  Within each cell the
    particles rank by the key's top ``hash_bits`` bits where an int32
    spares 8 or more beside the cell id, else by the whole key, ties by
    row; rank < K_c is kept.  With ``capped_reweight`` a particle's weight
    is its cell's occupancy / min(occupancy, K_c), else 1."""
    dev = bin_pos.device
    k_c = c["k_c"]
    nx, ny, nz = c["grid"]
    inv = torch.tensor(c["inv_cell"], dtype=torch.float32, device=dev)
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], device=dev)
    xyz = torch.floor(bin_pos.float() * inv).long()
    xyz = torch.minimum(xyz.clamp(min=0), hi)
    cell = (xyz[:, 2] * ny + xyz[:, 1]) * nx + xyz[:, 0]
    row = bin_row.long()
    key = (row * 2654435769) % (1 << 31)
    if c["hash_bits"] >= 8:
        key = key >> (31 - c["hash_bits"])
    # stable sorts, the least significant key first: row, key, cell
    o = torch.argsort(row)
    o = o[torch.sort(key[o], stable=True).indices]
    o = o[torch.sort(cell[o], stable=True).indices]
    _, occ = torch.unique_consecutive(cell[o], return_counts=True)
    first = torch.repeat_interleave(occ.cumsum(0) - occ, occ)
    rank = torch.empty_like(row)
    rank[o] = torch.arange(row.shape[0], device=dev) - first
    each = torch.empty_like(row)
    each[o] = torch.repeat_interleave(occ, occ)
    if c["capped_reweight"]:
        weight = each.float() / each.clamp(max=k_c).float()
    else:
        weight = torch.ones(row.shape[0], device=dev)
    return rank < k_c, weight


def step(c: dict, pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
         dtype: torch.dtype = torch.float32, bins: dict | None = None
         ) -> dict:
    """One step from (pos [N, 3], vel [N, 3], mass [N]) of the
    configuration whose constants are ``c``: the neighbor counts, the
    densities and accelerations at ``pos``, and the positions and
    velocities after the step, all in the callers' particle order.  In
    capped mode ``bins`` holds ``pos`` and ``row``, ``kept_set``'s
    ``bin_pos`` and ``bin_row``, in the callers' order."""
    kept = weight = None
    if c["k_c"]:
        if bins is None:
            raise ValueError("capped mode: the step needs its bins")
        kept, weight = kept_set(c, bins["pos"], bins["row"])
    pos, vel, mass = pos.to(dtype), vel.to(dtype), mass.to(dtype)
    grid = _Grid(c, pos, kept)
    o = grid.order
    xyz = [pos[o, a].contiguous() for a in range(3)]
    uvw = [vel[o, a].contiguous() for a in range(3)]
    m = mass[o]
    # the candidates' masses: reweighted in capped mode
    mc = m if weight is None else (mass * weight.to(dtype))[o]
    n = m.shape[0]
    rho = torch.zeros(n, dtype=dtype, device=pos.device)
    count = torch.zeros(n, dtype=torch.int32, device=pos.device)
    for lo, hi in grid.chunks():
        for rows, mask, _, _, _, d2 in grid.pairs(xyz, lo, hi, c["h2"]):
            t = c["h_s2"] - d2 * c["scale2"]
            w = mc[rows] * (c["poly6"] * t * t * t)
            rho[lo:hi] += torch.where(mask, w, 0.0).sum(-1)
            count[lo:hi] += mask.sum(-1, dtype=torch.int32)
    if c["self_density"]:
        h2s = c["h_s2"]
        rho = rho + m * c["poly6"] * h2s * h2s * h2s
    rho_inv = 1.0 / torch.where(rho > 0.0, rho, 1.0)
    pw = (rho - c["rho0"]) * c["stiffness"] * rho_inv * rho_inv
    acc = torch.zeros(n, 3, dtype=dtype, device=pos.device)
    for lo, hi in grid.chunks():
        press = [0.0, 0.0, 0.0]
        visc = [0.0, 0.0, 0.0]
        for rows, mask, dx, dy, dz, d2 in grid.pairs(xyz, lo, hi, c["h2"]):
            d = torch.sqrt(d2) * c["scale"]
            hd = torch.where(mask, c["h_s"] - d, 0.0)
            mj = mc[rows]
            center = torch.where(mask, hd * hd * mj
                                 * (pw[lo:hi, None] + pw[rows]), 0.0)
            q = center / (d + c["eps"]) * c["scale"]
            vw = torch.where(mask, hd * rho_inv[rows] * mj, 0.0)
            for a, da in enumerate((dx, dy, dz)):
                # (p_i - p_j) = -(p_j - p_i)
                press[a] = press[a] - (da * q).sum(-1)
                visc[a] = visc[a] + ((uvw[a][rows] - uvw[a][lo:hi, None])
                                     * vw).sum(-1)
        s = c["viscosity"] * rho_inv[lo:hi]
        acc[lo:hi] = torch.stack(
            [s * (c["visc_norm"] * visc[a]) + c["visc_norm"] * press[a]
             for a in range(3)], dim=-1)
    p_s = torch.stack(xyz, dim=-1)
    v_s = torch.stack(uvw, dim=-1)
    acc = acc + _central_gravity(c, p_s)
    acc = acc + torch.tensor(c["gravity"], dtype=dtype, device=pos.device)
    dot = (acc * acc).sum(-1, keepdim=True)
    lim = c["cfl"]
    acc = acc * torch.where(dot > lim * lim, lim / torch.sqrt(dot), 1.0)
    v_half = v_s + acc * (c["dt"] * 0.5)
    new_pos = p_s + v_half * c["pos_dt"]
    if c["second_kick"] == "gravity":
        new_vel = v_half + _central_gravity(c, new_pos) * c["dt"]
    elif c["second_kick"] == "none":
        new_vel = v_half
    else:
        raise ValueError(f"second_kick={c['second_kick']!r} is not a "
                         "one-pass step")
    if c["reflect"]:
        new_pos, new_vel = _reflect(c, p_s, new_pos, new_vel)
    out = {"count": count, "rho": rho, "acc": acc, "pos": new_pos,
           "vel": new_vel}
    # back to the callers' order
    for k, v in out.items():
        back = torch.empty_like(v)
        back[o] = v
        out[k] = back
    return out
