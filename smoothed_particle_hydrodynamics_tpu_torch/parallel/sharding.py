"""Row-sharded SPH step over a rank group: the replicated-binning halo
engine (counterpart of ``smoothed_particle_hydrodynamics_tpu/parallel/
sharding.py``, whose docstring sets out the decomposition).

Rank r owns rows ``[r*N/D, (r+1)*N/D)`` of the caller's particle order
(``shard_state``: JAX's ``P("data")``).  Every step each rank all-gathers
position, velocity and mass and bins and sorts the whole set with
``celllist.prepare`` (the replicated binning; the sort is stable, so every
rank gets the same permutation).  Rank r then sweeps sorted rows
``[r*N/D, (r+1)*N/D)``: a z-slab of space, since the cell id is z-major.

* ``step_sharded``, the gather oracle: the sweeps read the full sorted
  arrays, and rho is all-gathered between them (the JAX docstring's
  "widened gather").
* ``step_sharded_halo``: each rank ships ``halo_rows`` edge rows of its
  sorted slab to both ring neighbours (``SlabGroup.shift_up`` /
  ``shift_down``, JAX's ``ppermute``), zeroes the halos that wrapped
  around the chain ends, clamps its candidate ranges into
  ``[halo | own | halo]`` and counts the candidate rows the clamp cut
  (``halo_dropped``); rho's halos are exchanged the same way between the
  sweeps.

Both end alike: rho, count and acc of the swept rows are all-gathered,
unsorted with the grid's order, and each rank integrates its own shard
(``kdk_integrate``).  KE, PE, the L vector and the two loss counters are
summed over the ranks in one ``psum`` (|L| is the norm of the summed
vector); the neighbor statistics come from the gathered counts and
``overflow_cells`` from the replicated grid, so every rank returns the
same diagnostics.  The steps are plain functions every rank calls with the
same arguments, once per step (a host loop: ``run_steps_sharded``).

A gloo group on a card stages every message through host memory
(``comm.SlabGroup``); the all-gathers move O(N) rows a step, so this path
cannot weak-scale.  It exists to cross-check the slab engine, as in the
JAX package.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SphConfig
from ..ops import celllist
from ..ops.grid import cell_coords, unsort
from ..ops.integrate import EnergyTally, kdk_integrate
from ..state import (ParticleState, StepDiagnostics, diagnostics_rows,
                     make_step_diagnostics, stack_diagnostics,
                     state_from_numpy, state_to_numpy)
from .comm import SlabGroup


class RankLayout(NamedTuple):
    """Where each rank runs and how the ranks talk: ``devices[r]`` is rank
    r's device, ``backend`` the ``torch.distributed`` backend."""

    devices: tuple[str, ...]
    backend: str

    @property
    def world(self) -> int:
        return len(self.devices)

    @property
    def threads(self) -> int:
        """Each rank's torch threads: CPU ranks share the cores (with
        torch's default every rank spins on all of them); a card's rank
        needs one."""
        if self.devices[0] == "cpu":
            return max(1, (os.cpu_count() or 1) // self.world)
        return 1

    def describe(self) -> str:
        return f"devices=[{', '.join(self.devices)}] comm={self.backend}"


def make_mesh(n_devices: int | None = None,
              device: torch.device | str = "cuda") -> RankLayout:
    """The rank layout for ``n_devices`` ranks (default: one per card, or
    one on the CPU).

    With ``device`` cpu: gloo ranks on the CPU (the counterpart of JAX's
    virtual CPU mesh).  On cuda with at least ``n_devices`` cards: NCCL,
    rank r on ``cuda:r``.  With fewer cards: gloo, the ranks sharing the
    cards round-robin (NCCL refuses two ranks on one device).  No card is
    an error; no rank runs on the CPU when a card was asked for.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        n = n_devices or 1
        return RankLayout(("cpu",) * n, "gloo")
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: unsupported device {device!r}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        raise RuntimeError(f"make_mesh: no CUDA device for {device!r} "
                           "(device='cpu' runs gloo ranks on the CPU)")
    n = n_devices or cards
    if n <= cards:
        return RankLayout(tuple(f"cuda:{r}" for r in range(n)), "nccl")
    return RankLayout(tuple(f"cuda:{r % cards}" for r in range(n)), "gloo")


def shard_state(group: SlabGroup, state: ParticleState) -> ParticleState:
    """This rank's rows ``[r*N/D, (r+1)*N/D)`` of ``state``, on its
    device."""
    n, ndev = state.n, group.world
    if n % ndev:
        raise ValueError(
            f"num_particles={n} must be divisible by {ndev} devices")
    rows = n // ndev
    own = slice(group.rank * rows, (group.rank + 1) * rows)
    return ParticleState(*(f[own].to(group.device) for f in state))


def _gathered(group: SlabGroup, local: ParticleState) -> ParticleState:
    """Every rank's position, velocity and mass, in the caller's order."""
    cols = torch.cat([local.position, local.velocity, local.mass[:, None]],
                     dim=1)
    full = group.all_gather(cols).reshape(-1, 7)
    return ParticleState.from_arrays(full[:, 0:3], full[:, 3:6],
                                     mass=full[:, 6])


def _finish(cfg: SphConfig, group: SlabGroup, local: ParticleState,
            p: celllist.Prepared, rho_l: torch.Tensor, nc_l: torch.Tensor,
            acc_l: torch.Tensor, losses: torch.Tensor
            ) -> tuple[ParticleState, StepDiagnostics]:
    """Gather the swept rows' rho, count and acc, unsort, integrate this
    rank's shard and reduce the diagnostics (``losses``: [truncated, halo
    cut] of this rank)."""
    rows, r = local.n, group.rank
    cols = torch.cat([rho_l[:, None], nc_l.to(torch.float32)[:, None],
                      acc_l], dim=1)
    full = unsort(p.grid.order, group.all_gather(cols).reshape(-1, 5))
    own = full[r * rows:(r + 1) * rows]
    ncount = full[:, 1].to(torch.int32)
    local = local._replace(density=own[:, 0],
                           neighbor_count=ncount[r * rows:(r + 1) * rows])
    new_local, tally = kdk_integrate(cfg, local, own[:, 2:5].contiguous())
    s = group.psum(torch.cat([
        torch.stack([tally.kinetic, tally.potential]).double(),
        tally.l_vec.double(), losses.double()]))
    l_vec = s[2:5].float()
    total = EnergyTally(s[0].float(), s[1].float(), torch.linalg.norm(l_vec),
                        l_vec)
    diag = make_step_diagnostics(
        total, ncount, p.grid.overflow_cells,
        truncated_ranges=s[5].to(torch.int32),
        halo_dropped=s[6].to(torch.int32))
    return new_local, diag


def _chunk(chunk: int | None, rows: int, device: torch.device) -> int:
    return min(chunk or celllist.default_chunk(device), rows)


def step_sharded(cfg: SphConfig, group: SlabGroup, local: ParticleState,
                 chunk: int | None = None
                 ) -> tuple[ParticleState, StepDiagnostics]:
    """One step of this rank's shard, the gather oracle: the sweeps of its
    sorted rows read the full sorted arrays, rho all-gathered between
    them.  Every rank calls it with its own ``shard_state`` rows."""
    rows, r = local.n, group.rank
    p = celllist.prepare(cfg, _gathered(group, local))
    own = slice(r * rows, (r + 1) * rows)
    own_idx = torch.arange(r * rows, (r + 1) * rows, dtype=torch.int32,
                           device=local.position.device)
    ch = _chunk(chunk, rows, local.position.device)
    rng_s, rng_e = p.rng_start[own], p.rng_end[own]
    rho_l, nc_l, trunc = celllist.density_rows(
        cfg, p.pos_s, p.mass_s, rng_s, rng_e, own_idx, p.pos_s[own],
        p.mass_s[own], chunk=ch)
    rho_s = group.all_gather(rho_l).reshape(-1)
    acc_l = celllist.force_rows(
        cfg, p.pos_s, p.vel_s, p.mass_s, rho_s, rng_s, rng_e, own_idx,
        p.pos_s[own], p.vel_s[own], rho_l, chunk=ch)
    losses = torch.stack([trunc.sum(), torch.zeros_like(trunc.sum())])
    return _finish(cfg, group, local, p, rho_l, nc_l, acc_l, losses)


def _edges(group: SlabGroup, t: torch.Tensor, h: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank - 1's last ``h`` rows, rank + 1's first ``h`` rows) of ``t``,
    zero at the chain ends (no periodic space)."""
    from_left = group.shift_up(t[-h:])
    from_right = group.shift_down(t[:h])
    if group.rank == 0:
        from_left = torch.zeros_like(from_left)
    if group.rank == group.world - 1:
        from_right = torch.zeros_like(from_right)
    return from_left, from_right


def step_sharded_halo(cfg: SphConfig, group: SlabGroup, local: ParticleState,
                      halo_rows: int, chunk: int | None = None
                      ) -> tuple[ParticleState, StepDiagnostics]:
    """One step of this rank's shard with a halo exchange in place of the
    gathered neighbor fields (module docstring).  Candidates beyond the
    halo are dropped and counted in ``halo_dropped``; size ``halo_rows``
    with ``derive_halo_rows``."""
    rows, r, h = local.n, group.rank, halo_rows
    if h > rows:
        raise ValueError("halo_rows must be <= rows per device")
    dev = local.position.device
    p = celllist.prepare(cfg, _gathered(group, local))
    own = slice(r * rows, (r + 1) * rows)
    fields_loc = torch.cat([p.pos_s[own], p.vel_s[own], p.mass_s[own, None]],
                           dim=1)                              # [rows, 7]
    from_left, from_right = _edges(group, fields_loc, h)
    ext = torch.cat([from_left, fields_loc, from_right])

    # clamp the candidate ranges into the halo band; count the candidate
    # rows cut (empty [0, 0) ranges of out-of-grid rods do not count)
    rng_s, rng_e = p.rng_start[own], p.rng_end[own]
    base = r * rows - h                                # global row of ext[0]
    lo = torch.clamp(rng_s, min=base)
    hi = torch.clamp(rng_e, max=(r + 1) * rows + h)
    cut_left = torch.clamp(torch.minimum(rng_e, lo) - rng_s, min=0)
    cut_right = torch.clamp(rng_e - torch.maximum(rng_s, hi), min=0)
    cut = (cut_left + cut_right).sum()
    lo = lo - base
    hi = torch.maximum(hi - base, lo)

    pos_e, vel_e, mass_e = ext[:, 0:3], ext[:, 3:6], ext[:, 6]
    own_l = torch.arange(h, h + rows, dtype=torch.int32, device=dev)
    pos_i, vel_i, mass_i = fields_loc[:, 0:3], fields_loc[:, 3:6], fields_loc[:, 6]
    ch = _chunk(chunk, rows, dev)
    rho_l, nc_l, trunc = celllist.density_rows(
        cfg, pos_e, mass_e, lo, hi, own_l, pos_i, mass_i, chunk=ch)
    # the force sweep needs the halo rows' densities: exchange them too
    rho_left, rho_right = _edges(group, rho_l, h)
    rho_e = torch.cat([rho_left, rho_l, rho_right])
    acc_l = celllist.force_rows(
        cfg, pos_e, vel_e, mass_e, rho_e, lo, hi, own_l, pos_i, vel_i, rho_l,
        chunk=ch)
    losses = torch.stack([trunc.sum(), cut.to(trunc.dtype)])
    return _finish(cfg, group, local, p, rho_l, nc_l, acc_l, losses)


def run_steps_sharded(cfg: SphConfig, group: SlabGroup, local: ParticleState,
                      num_steps: int, chunk: int | None = None
                      ) -> tuple[ParticleState, StepDiagnostics]:
    """``num_steps`` gather-oracle steps (a host loop); diagnostics with a
    leading [num_steps] axis."""
    diags = []
    for _ in range(num_steps):
        local, d = step_sharded(cfg, group, local, chunk=chunk)
        diags.append(d)
    return local, stack_diagnostics(diags)


def derive_halo_rows(cfg: SphConfig, state: ParticleState,
                     n_devices: int) -> int:
    """Halo size from the state's cell-plane occupancy (host-side): one
    halo side covers the densest adjacent plane pair's population, with
    25 % headroom, at least 64, rounded up to 8 and capped at the rows per
    device (the JAX package's rule, bit for bit)."""
    z = cell_coords(cfg, state.position)[:, 2].cpu().numpy()
    pop = np.bincount(z, minlength=cfg.grid_nz).astype(np.int64)
    need = int((pop[:-1] + pop[1:]).max()) if cfg.grid_nz > 1 else int(pop[0])
    rows = state.n // max(n_devices, 1)
    halo = min(rows, max(64, (need * 5) // 4))
    return -(-halo // 8) * 8 if halo < rows else rows


def make_sharded_step(cfg: SphConfig, group: SlabGroup, donate: bool = True,
                      halo_rows: int | None = None, variant: str = "halo",
                      chunk: int | None = None
                      ) -> Callable[[ParticleState],
                                    tuple[ParticleState, StepDiagnostics]]:
    """This rank's multi-rank step: the halo exchange, its halo derived from
    the first state's plane occupancy when ``halo_rows`` is None (a gather
    of the positions).  ``variant="gather"`` is the replicated-gather
    oracle.  ``donate`` is accepted for the JAX signature and does
    nothing."""
    del donate
    if variant == "gather":
        return partial(step_sharded, cfg, group, chunk=chunk)
    if variant != "halo":
        raise ValueError(f"unknown sharded-step variant: {variant!r}")

    def run(local: ParticleState):
        nonlocal halo_rows
        if halo_rows is None:
            halo_rows = derive_halo_rows(cfg, _gathered(group, local),
                                         group.world)
        return step_sharded_halo(cfg, group, local, halo_rows, chunk=chunk)

    return run


def gather_state(group: SlabGroup, local: ParticleState) -> ParticleState:
    """Every rank's shard, all six fields, in the caller's order (a
    collective; the inverse of ``shard_state``)."""
    return ParticleState(*(group.all_gather(f).reshape(-1, *f.shape[1:])
                           for f in local))


def run_sharded_steps(group: SlabGroup, cfg: SphConfig, state, steps: int = 1,
                      variant: str = "halo", halo_rows: int | None = None,
                      chunk: int | None = None) -> dict:
    """Shard ``state`` (a ParticleState or a ``state_to_numpy`` dict), run
    ``steps`` sharded steps on every rank of ``group``, gather.  Returns
    numpy / plain values (``spawn_ranks`` pickles them): the gathered
    state, the per-step diagnostics and this rank's permutation of the
    first step's replicated binning (every rank must sort alike); the
    state from rank 0 only (None from the others)."""
    if isinstance(state, dict):
        state = state_from_numpy(state, group.device)
    local = shard_state(group, state)
    order = celllist.prepare(cfg, _gathered(group, local)).grid.order
    step = make_sharded_step(cfg, group, halo_rows=halo_rows,
                             variant=variant, chunk=chunk)
    diags = []
    for _ in range(steps):
        local, d = step(local)
        diags.append(d)
    full = gather_state(group, local)
    return dict(state=state_to_numpy(full) if group.rank == 0 else None,
                diags=diagnostics_rows(diags), order=order.cpu().numpy())


def run_sharded_jobs(group: SlabGroup, jobs: list[dict]) -> list[dict]:
    """``run_sharded_steps`` for each job's keyword arguments, in order (one
    spawn of ranks for several runs)."""
    return [run_sharded_steps(group, **job) for job in jobs]


class HaloRanks:
    """A ``comm.RankPool`` worker: this rank's shard of a ``run --devices
    N --partition halo``, stepped by the halo step.  Replies are numpy
    dicts from rank 0 (None from the others)."""

    def __init__(self, group: SlabGroup, cfg_json: str, state: dict,
                 chunk: int | None = None):
        self.group, self.chunk = group, chunk
        self.local = shard_state(group, state_from_numpy(state, group.device))
        self.rebuild(cfg_json)

    def rebuild(self, cfg_json: str) -> None:
        """A new config: a fresh step, its halo derived from the current
        state (the JAX CLI's ``make_run``)."""
        self.cfg = SphConfig.from_json(cfg_json)
        self.step_fn = make_sharded_step(self.cfg, self.group,
                                         chunk=self.chunk)

    def step(self, n: int) -> dict | None:
        diags = []
        for _ in range(n):
            self.local, d = self.step_fn(self.local)
            diags.append(d)
        return diagnostics_rows(diags) if self.group.rank == 0 else None

    def collect(self) -> dict | None:
        """The whole state in the caller's order (a collective)."""
        full = gather_state(self.group, self.local)
        return state_to_numpy(full) if self.group.rank == 0 else None

    def report(self) -> dict:
        """This rank's rows (the halo step launches no kernel)."""
        return dict(launches={}, count=self.local.n, band_halo=None)
