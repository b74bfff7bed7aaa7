"""Per-phase timings in the reference's ``timing.txt`` vocabulary
(counterpart of ``smoothed_particle_hydrodynamics_tpu/utils/profiling.py``).

The reference brackets each of its six step phases with a timer and writes
per-step times to ``out/timing.txt`` (``src/sph.cpp:192-299``).
``profile_phases`` runs the same phases one at a time on the cell-list
path, each timed on the host clock around work that ends in a device
sync; ``run --profile-phases`` measures them once and writes them beside
every step's time.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..config import SphConfig
from ..state import ParticleState


def device_sync(out) -> None:
    """Wait for the card when any tensor of ``out`` (nested tuples too)
    lies on it."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for leaf in out:
            device_sync(leaf)


def timeit(fn: Callable, *args, iters: int = 10) -> float:
    """Mean wall-clock of ``fn(*args)`` over ``iters`` calls after one
    warmup call, ms per call."""
    device_sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    device_sync(out)
    return (time.perf_counter() - t0) / iters * 1000.0


def profile_phases(cfg: SphConfig, state: ParticleState, iters: int = 10
                   ) -> dict[str, float]:
    """Phase timings [ms] in the reference's timing.txt vocabulary.

    voxelize     = binning + sort (``ops.grid.build_grid``)
    neighbors    = candidate-range construction (``celllist.prepare`` less
                   the binning)
    density      = density sweep (``celllist.density_rows``)
    pressure     = 0 (inlined into the forces, like the reference's empty
                   computePressure pass, src/sph.cpp:256-262)
    acceleration = force sweep, gravity and CFL (``celllist.force_rows``)
    integrate    = KDK + tallies (``integrate.kdk_integrate``)
    """
    from ..ops import celllist
    from ..ops.grid import build_grid
    from ..ops.integrate import kdk_integrate

    times: dict[str, float] = {}
    times["voxelize"] = timeit(lambda p: build_grid(cfg, p), state.position,
                               iters=iters)
    prep = celllist.prepare(cfg, state)
    times["neighbors"] = max(
        timeit(lambda s: celllist.prepare(cfg, s), state, iters=iters)
        - times["voxelize"], 0.0)

    own = torch.arange(state.n, dtype=torch.int32, device=prep.pos_s.device)
    dens_args = (prep.pos_s, prep.mass_s, prep.rng_start, prep.rng_end, own,
                 prep.pos_s, prep.mass_s)
    rho_s, _, _ = celllist.density_rows(cfg, *dens_args)
    times["density"] = timeit(lambda *a: celllist.density_rows(cfg, *a),
                              *dens_args, iters=iters)
    times["pressure"] = 0.0
    times["acceleration"] = timeit(
        lambda *a: celllist.force_rows(cfg, *a), prep.pos_s, prep.vel_s,
        prep.mass_s, rho_s, prep.rng_start, prep.rng_end, own, prep.pos_s,
        prep.vel_s, rho_s, iters=iters)
    acc = torch.zeros_like(state.position)
    times["integrate"] = timeit(lambda s, a: kdk_integrate(cfg, s, a), state,
                                acc, iters=iters)
    return times


def profile_step(cfg: SphConfig, state: ParticleState,
                 backend: str = "celllist", iters: int = 10) -> float:
    """Whole-step time [ms] for the given backend."""
    from ..ops.step import step

    return timeit(lambda s: step(cfg, s, backend=backend), state,
                  iters=iters)
