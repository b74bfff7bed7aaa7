"""Throughput benchmark and backend parity check (counterpart of
``smoothed_particle_hydrodynamics_tpu/utils/benchmark.py``).

``run_benchmark``: steady-state particle-steps/s of a step loop after
warmup; ``run_slab_benchmark`` the same for the distributed slab engine on
a one-rank group.  The fence is ``torch.cuda.synchronize()``: the host clock runs
around work that ends in a device sync.  ``run_parity_check``: the
``pallas`` sweeps against the ``celllist`` sweeps on one state.  A CUDA run
reports the card it ran on; a CPU run (tests, small n) says ``cpu`` and is
never a device number.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SphConfig
from ..models import make_scene
from ..state import ParticleState


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device")
    return dev


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def resolve_sweep_settings(cfg: SphConfig, state: ParticleState,
                           overrides: dict, backend: str = "pallas"
                           ) -> SphConfig:
    """The settings the JAX CLI resolves before a run (``cli.py:101-129``),
    shared by ``run``, ``bench`` and ``sweep``.  For the pallas backend:
    capped mode takes 256-row blocks unless ``overrides`` set
    ``pallas_block_t`` (its windows are K_c-bounded, so wider blocks halve
    the per-(block, rod) visits for little window growth);
    ``pallas_window_t=0`` derives the sublane window from this state
    (capped-aware); capped ``capped_sub_len=0`` derives the sub-frame bound
    from the occupancy histogram.  For every backend ``range_slice=0``
    derives the cell-list candidate slice from the 3-cell occupancies."""
    from ..ops import celllist, sweeps_t

    if backend == "pallas":
        if cfg.capped_candidates and "pallas_block_t" not in overrides:
            cfg = cfg.replace(pallas_block_t=256)
        if cfg.pallas_window_t == 0:
            cfg = cfg.replace(
                pallas_window_t=sweeps_t.derive_window_t(cfg, state))
        if cfg.capped_candidates and cfg.capped_sub_len == 0:
            cfg = cfg.replace(
                capped_sub_len=sweeps_t.derive_sub_len(cfg, state))
    if cfg.range_slice == 0:
        cfg = cfg.replace(range_slice=celllist.derive_range_slice(cfg, state))
    return cfg


def resolve_scene(scene: str, device: torch.device, overrides: dict,
                  seed: int | None = None, backend: str = "pallas"
                  ) -> tuple[SphConfig, ParticleState]:
    """The scene a run or a benchmark steps (the CLI's ``run`` and
    ``bench``, ``run_benchmark``): ``make_scene`` with ``overrides`` (the
    scene's own size unless they set ``num_particles``) and ``seed`` (the
    scene's own when None), the sweep settings resolved, and the config
    validated (``SphConfig.validate`` raises ValueError) before any step."""
    kw = dict(overrides)
    if seed is not None:
        kw["seed"] = seed
    cfg, state = make_scene(scene, device=device, **kw)
    cfg = resolve_sweep_settings(cfg, state, overrides, backend)
    cfg.validate()
    return cfg, state


def uses_lazy(cfg: SphConfig, backend: str) -> bool:
    """The JAX CLI's rule for driving the lazy loop (``cli.py:242-246``):
    the pallas backend in the sublane layout, default mode, and a closing
    kick that needs no force re-evaluation."""
    return (backend == "pallas" and not cfg.compat
            and cfg.pallas_layout == "sublane" and cfg.second_kick != "full")


def run_benchmark(scene: str = "disk", lazy: bool | None = False,
                  steps: int = 100, warmup: int = 10,
                  overrides: dict | None = None, device: str = "cuda",
                  seed: int | None = None, backend: str = "celllist") -> dict:
    """Run ``warmup`` steps, then time ``steps`` steps; returns one record.
    The defaults are the JAX package's (``utils/benchmark.py:27-29``).

    ``lazy=True`` drives ``ops.lazy.drive_loop_lazy`` (the production path,
    the pallas backend only); ``lazy=False`` the eager per-step-rebin
    ``ops.step.drive_loop`` on ``backend``; ``lazy=None`` picks by
    ``uses_lazy``.
    """
    from ..ops.lazy import drive_loop_lazy
    from ..ops.step import drive_loop

    if lazy and backend != "pallas":
        # the lazy driver always runs the sublane sweeps; a record labelled
        # with another backend would name an engine that never ran
        raise ValueError(f"lazy=True benchmarks the pallas backend; got "
                         f"backend={backend!r}")
    dev = _device(device)
    cfg, state = resolve_scene(scene, dev, overrides or {}, seed, backend)
    if lazy is None:
        lazy = uses_lazy(cfg, backend)

    if lazy:
        def advance(carry, n, first=False):
            return drive_loop_lazy(cfg, carry if first else None, n,
                                   carry=None if first else carry,
                                   keep_carry=True)
    else:
        def advance(st, n, first=False):
            return drive_loop(cfg, st, n, backend=backend)

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

    def per_step(name):  # warmup steps first
        return (getattr(wdiags, name).tolist()
                + getattr(diags, name).tolist())

    return {
        "metric": "particle-steps/sec/chip",
        "value": n * steps / elapsed,
        "unit": "particle-steps/s",
        "ms_per_step": elapsed * 1000.0 / steps,
        "scene": scene,
        "backend": backend,
        "pallas_layout": cfg.pallas_layout,
        "lazy": lazy,
        "num_particles": n,
        "steps": steps,
        "warmup_steps": max(warmup, 1),
        "warmup_s": warmup_s,
        "window_t": cfg.pallas_window_t,
        "block_t": cfg.pallas_block_t,
        "window": cfg.pallas_window,          # lane layout
        "block_rows": cfg.pallas_block_rows,  # lane layout
        "capped_sub_len": cfg.capped_sub_len,
        # rebins inside the timed steps (the eager loop rebins every step)
        "rebins": carry.rebin_count - rebins_before if lazy else steps,
        "kinetic_energy": diags.kinetic_energy.tolist(),
        "neighbor_mean": diags.neighbor_mean.tolist(),
        # per step, warmup steps first: candidates dropped (capped sub-frame
        # overflow, lane chunks beyond the 127 clamp, cell-list slices) and
        # cells over cell_capacity
        "truncated_ranges": per_step("truncated_ranges"),
        "overflow_cells": per_step("overflow_cells"),
        "finite": bool(torch.isfinite(final.position).all()
                       and torch.isfinite(final.velocity).all()
                       and torch.isfinite(diags.kinetic_energy).all()),
        "device": _device_name(dev),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
    }


def slab_sizes(cfg: SphConfig, state: ParticleState, headroom: float
               ) -> tuple[tuple[int, ...], tuple[int, int, int], int | None]:
    """A one-rank slab run's (z split, (p_cap, h_cap, m_cap) at
    ``headroom``, capped sub-frame bound or None), from ``state``."""
    from ..parallel import slabs

    zsplit = slabs.derive_zsplit(cfg, state, 1)
    caps = slabs.derive_slab_caps(cfg, state, 1, zsplit=zsplit,
                                  headroom=headroom)
    sub_len = (slabs.derive_sub_len_slab(cfg, state, 1, zsplit)
               if cfg.capped_candidates else None)
    return zsplit, caps, sub_len


def slab_setup(n: int, overrides: dict | None, headroom: float,
               device: torch.device, seed: int | None = None):
    """The slab benchmark's one-rank run: the splash scene on 1.25h cells
    (``overrides`` win), its sublane window derived unless set, the config
    validated, the split, caps at ``headroom`` and the capped sub-frame
    bound.  Returns (cfg,
    state, zsplit, caps, sub_len)."""
    from ..ops.sweeps_t import derive_window_t

    ov = dict(num_particles=n, cell_size_factor=1.25)
    ov.update(overrides or {})
    if seed is not None:
        ov["seed"] = seed
    cfg, state = make_scene("splash", device=device, **ov)
    if cfg.pallas_window_t == 0 or "pallas_window_t" not in ov:
        cfg = cfg.replace(pallas_window_t=derive_window_t(cfg, state))
    cfg.validate()
    return (cfg, state) + slab_sizes(cfg, state, headroom)


def run_slab_benchmark(n: int = 1_000_000, steps: int = 15, warmup: int = 3,
                       sweeps: str = "pallas", headroom: float = 1.05,
                       overrides: dict | None = None, scan_block: int = 0,
                       device: str = "cuda", seed: int | None = None) -> dict:
    """The distributed slab engine on a one-rank group of this device (the
    JAX package's ``run_slab_benchmark``, ``utils/benchmark.py:94``): the
    1M splash on 1.25h cells, sublane window derived from the state unless
    ``overrides`` set one, split and caps derived at ``headroom``.  On the
    card the group is an NCCL group of one rank, so the step's collectives
    run through NCCL; on the CPU it is gloo.  ``scan_block=K`` advances K
    steps per call.  Returns the JAX package's keys plus per-step counters
    (warmup steps first) and a finiteness flag."""
    from ..parallel import comm, slabs

    dev = _device(device)
    cfg, state, zsplit, (p_cap, h_cap, m_cap), sub_len = slab_setup(
        n, overrides, headroom, dev, seed)
    k = max(scan_block, 1)
    with comm.local_group(dev) as group:
        carry = slabs.distribute(cfg, state, group, p_cap, zsplit=zsplit)
        step = slabs.make_slab_step(cfg, group, p_cap, h_cap, m_cap,
                                    sweeps=sweeps, zsplit=zsplit,
                                    sub_len=sub_len, scan_block=scan_block)
        diags = []
        t0 = time.perf_counter()
        for _ in range(max(-(-warmup // k), 1)):
            carry, d = step(carry)
            diags.append(d)
        _sync(dev)
        warmup_s = time.perf_counter() - t0
        warm_steps = len(diags) * k
        rebins_before = carry.rebin_count
        calls = max(steps // k, 1)
        t0 = time.perf_counter()
        for _ in range(calls):
            carry, d = step(carry)
            diags.append(d)
        _sync(dev)
        elapsed = time.perf_counter() - t0
    steps_run = calls * k
    per_step = {name: torch.stack([v.reshape(-1) for v in vals]).reshape(-1)
                for name, vals in zip(diags[0]._fields, zip(*diags))}
    return {
        "metric": "slab-engine particle-steps/s (one-rank group)",
        "value": n * steps_run / elapsed,
        "ms_per_step": elapsed * 1000.0 / steps_run,
        "num_particles": n,
        "steps": steps_run,
        "warmup_steps": warm_steps,
        "sweeps": sweeps,
        "scan_block": scan_block,
        "p_cap": p_cap, "h_cap": h_cap, "m_cap": m_cap,
        "window_t": cfg.pallas_window_t,
        "block_t": cfg.pallas_block_t,
        "sub_len": sub_len,
        "rebins": carry.rebin_count - rebins_before,
        "migration_dropped": int(per_step["migration_dropped"][-1]),
        "halo_dropped": int(per_step["halo_dropped"][-1]),
        "warmup_s": warmup_s,
        # per step, warmup steps first
        "truncated_ranges": per_step["truncated_ranges"].tolist(),
        "halo_dropped_steps": per_step["halo_dropped"].tolist(),
        "migration_dropped_steps": per_step["migration_dropped"].tolist(),
        "neighbor_mean": per_step["neighbor_mean"].tolist(),
        "kinetic_energy": per_step["kinetic_energy"].tolist(),
        "finite": bool(torch.isfinite(carry.fields[:, 0:6]).all()
                       and torch.isfinite(per_step["kinetic_energy"]).all()),
        "device": _device_name(dev),
    }


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.detach().cpu().double().numpy()
    b = b.detach().cpu().double().numpy()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def run_parity_check(n: int = 32768, scene: str = "disk",
                     device: str = "cuda") -> dict:
    """``pallas`` (the config's layout, sublane by default) against
    ``celllist`` on the same state: neighbor counts equal, rho rel-L2
    < 1e-5, acc rel-L2 < 1e-4.  On the CPU the kernels' plain twins run and
    n is capped at 2048, as the JAX package caps its interpreter-mode run;
    on the card the kernels run.  Returns the JAX package's keys."""
    from ..ops.step import compute_forces

    dev = _device(device)
    on_cpu = dev.type == "cpu"
    if on_cpu:
        n = min(n, 2048)
    cfg, state = make_scene(scene, num_particles=n, device=dev)
    acc_p, rho_p, aux_p = compute_forces(cfg, state, backend="pallas")
    acc_c, rho_c, aux_c = compute_forces(cfg, state, backend="celllist")
    nc_equal = bool(torch.equal(aux_p.neighbor_count, aux_c.neighbor_count))
    rho_l2, acc_l2 = _rel_l2(rho_p, rho_c), _rel_l2(acc_p, acc_c)
    return {
        "n": n,
        "scene": scene,
        "device": _device_name(dev),
        "interpret": on_cpu,
        "neighbor_counts_equal": nc_equal,
        "rho_rel_l2": rho_l2,
        "acc_rel_l2": acc_l2,
        "pass": nc_equal and rho_l2 < 1e-5 and acc_l2 < 1e-4,
    }
