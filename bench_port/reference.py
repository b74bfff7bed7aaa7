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
"""

from __future__ import annotations

import torch

# neighbor cells, (dx, dy, dz) each in {-1, 0, 1}
OFFSETS = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]
# pair elements per chunk ([rows, cell rows] tensors), bounding its memory
PAIR_BUDGET = 1 << 24


class _Grid:
    """Particles sorted by cell of a grid with edges of at least h."""

    def __init__(self, c: dict, pos: torch.Tensor):
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
        cell: (rows [R, L] of the cell's particles, mask of the pairs
        within h, dx, dy, dz, d^2), each [R, L], the offsets candidate
        minus self."""
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


def step(c: dict, pos: torch.Tensor, vel: torch.Tensor, mass: torch.Tensor,
         dtype: torch.dtype = torch.float32) -> dict:
    """One step from (pos [N, 3], vel [N, 3], mass [N]) of the
    configuration whose constants are ``c``: the neighbor counts, the
    densities and accelerations at ``pos``, and the positions and
    velocities after the step, all in the callers' particle order."""
    pos, vel, mass = pos.to(dtype), vel.to(dtype), mass.to(dtype)
    grid = _Grid(c, pos)
    o = grid.order
    xyz = [pos[o, a].contiguous() for a in range(3)]
    uvw = [vel[o, a].contiguous() for a in range(3)]
    m = mass[o]
    n = m.shape[0]
    rho = torch.zeros(n, dtype=dtype, device=pos.device)
    count = torch.zeros(n, dtype=torch.int32, device=pos.device)
    for lo, hi in grid.chunks():
        for rows, mask, _, _, _, d2 in grid.pairs(xyz, lo, hi, c["h2"]):
            t = c["h_s2"] - d2 * c["scale2"]
            w = m[rows] * (c["poly6"] * t * t * t)
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
            mj = m[rows]
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
