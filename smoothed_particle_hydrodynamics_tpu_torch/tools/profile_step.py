"""Phase-by-phase times of the cell-list step: counterpart of
``tools/profile_step.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.profile_step \\
        [N] [chunk] [--device cpu]

On the disk (default the reference's 32,768 particles), times the grid
(``ops.grid.build_grid``: the sort and the cell offsets), the cell-list
``prepare`` (grid and candidate ranges), its density and force sweeps over
``chunk`` rows at a time (``ops.celllist.density_rows``, ``force_rows``),
the unsort and the whole eager step (``ops.step.step``, backend
``celllist``): host clock over 20 calls (10 for the step), ended by a
device sync.  This is not ``utils/profile_step.py``, which traces a step
loop with ``torch.profiler``.
"""

from __future__ import annotations

import argparse

import torch

from ..models import make_scene
from ..ops import celllist
from ..ops.grid import build_grid, unsort
from ..ops.step import step
from . import Phases, start


def main(n=32768, chunk=1024, device="cuda", iters: int = 20) -> dict:
    dev = start(device)
    cfg, state = make_scene("disk", device=dev, num_particles=n)
    print(f"n={n} chunk={chunk} device={dev}")
    ph = Phases(dev, width=28)

    ph.host("build_grid (sort+offsets)", build_grid, cfg, state.position,
            iters=iters)
    p = ph.host("prepare (grid+ranges)", celllist.prepare, cfg, state,
                iters=iters)
    own = torch.arange(n, dtype=torch.int32, device=dev)
    rho_s, _, _ = ph.host(
        "density sweep", celllist.density_rows, cfg,
        p.pos_s, p.mass_s, p.rng_start, p.rng_end, own, p.pos_s, p.mass_s,
        chunk, iters=iters)
    acc_s = ph.host(
        "force sweep", celllist.force_rows, cfg,
        p.pos_s, p.vel_s, p.mass_s, rho_s, p.rng_start, p.rng_end, own,
        p.pos_s, p.vel_s, rho_s, chunk, iters=iters)
    ph.host("unsort", unsort, p.grid.order, acc_s, iters=iters)
    ph.host("full step", step, cfg, state, iters=max(iters // 2, 1))
    return dict(ms=ph.ms)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "profile_step")
    ap.add_argument("n", nargs="?", type=int, default=32768)
    ap.add_argument("chunk", nargs="?", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.chunk, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
