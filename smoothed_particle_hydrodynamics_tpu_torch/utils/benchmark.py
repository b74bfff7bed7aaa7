"""Throughput benchmark (counterpart of
``smoothed_particle_hydrodynamics_tpu/utils/benchmark.py::run_benchmark``).

Steady-state particle-steps/s of the step loop after warmup.  The fence is
``torch.cuda.synchronize()``: the host clock runs around work that ends in
a device sync.  A CUDA run reports the card it ran on; a CPU run (tests,
small n) says ``cpu`` and is never a device number.
"""

from __future__ import annotations

import time

import torch

from ..config import SphConfig
from ..models import make_scene
from ..state import ParticleState


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def resolve_sweep_settings(cfg: SphConfig, state: ParticleState,
                           overrides: dict) -> SphConfig:
    """The settings the JAX CLI resolves before a run on the sweeps
    (``cli.py:101-123``), shared by ``run`` and ``bench``: capped mode takes
    256-row blocks unless ``overrides`` set ``pallas_block_t`` (its windows
    are K_c-bounded, so wider blocks halve the per-(block, rod) visits for
    little window growth); ``pallas_window_t=0`` derives the window from
    this state (capped-aware); capped ``capped_sub_len=0`` derives the
    sub-frame bound from the occupancy histogram."""
    from ..ops import sweeps_t

    if cfg.capped_candidates and "pallas_block_t" not in overrides:
        cfg = cfg.replace(pallas_block_t=256)
    if cfg.pallas_window_t == 0:
        cfg = cfg.replace(pallas_window_t=sweeps_t.derive_window_t(cfg, state))
    if cfg.capped_candidates and cfg.capped_sub_len == 0:
        cfg = cfg.replace(capped_sub_len=sweeps_t.derive_sub_len(cfg, state))
    return cfg


def run_benchmark(scene: str = "splash", lazy: bool = True, steps: int = 20,
                  warmup: int = 3, overrides: dict | None = None,
                  device: str = "cuda", seed: int | None = None) -> dict:
    """Run ``warmup`` steps, then time ``steps`` steps; returns one record.

    ``lazy=True`` drives ``ops.lazy.drive_loop_lazy`` (the production path);
    ``lazy=False`` the eager per-step-rebin ``ops.step.drive_loop``.
    """
    from ..ops.lazy import drive_loop_lazy
    from ..ops.step import drive_loop

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_benchmark(device='cuda'): no CUDA device")
    kw = dict(overrides or {})
    if seed is not None:
        kw["seed"] = seed
    cfg, state = make_scene(scene, device=dev, **kw)
    cfg = resolve_sweep_settings(cfg, state, kw)

    if lazy:
        def advance(carry, n, first=False):
            return drive_loop_lazy(cfg, carry if first else None, n,
                                   carry=None if first else carry,
                                   keep_carry=True)
    else:
        def advance(st, n, first=False):
            return drive_loop(cfg, st, n)

    t0 = time.perf_counter()
    carry, wdiags = advance(state, max(warmup, 1), first=True)
    _sync(dev)
    warmup_s = time.perf_counter() - t0
    rebins_before = carry.rebin_count if lazy else 0

    t0 = time.perf_counter()
    carry, diags = advance(carry, steps)
    _sync(dev)
    elapsed = time.perf_counter() - t0

    final = carry.state if lazy else carry
    n = cfg.num_particles
    return {
        "metric": "particle-steps/s",
        "value": n * steps / elapsed,
        "ms_per_step": elapsed * 1000.0 / steps,
        "scene": scene,
        "lazy": lazy,
        "num_particles": n,
        "steps": steps,
        "warmup_steps": max(warmup, 1),
        "warmup_s": warmup_s,
        "window_t": cfg.pallas_window_t,
        "block_t": cfg.pallas_block_t,
        "capped_sub_len": cfg.capped_sub_len,
        # rebins inside the timed steps (the eager loop rebins every step)
        "rebins": carry.rebin_count - rebins_before if lazy else steps,
        "kinetic_energy": diags.kinetic_energy.tolist(),
        "neighbor_mean": diags.neighbor_mean.tolist(),
        # candidate rows dropped per step, warmup steps first (capped
        # sub-frame overflow)
        "truncated_ranges": (wdiags.truncated_ranges.tolist()
                             + diags.truncated_ranges.tolist()),
        "finite": bool(torch.isfinite(final.position).all()
                       and torch.isfinite(final.velocity).all()
                       and torch.isfinite(diags.kinetic_energy).all()),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
