"""Where a step's time goes on the card: ``torch.profiler`` over a short
steady window of the step loop, beside untraced timings.

    python -m smoothed_particle_hydrodynamics_tpu_torch.utils.profile_step \\
        --scene splash -n 1000000 --set pallas_layout=lane

runs ``--repeats`` untraced ``run_benchmark`` runs (``--warmup`` + ``--steps``
steps each), then traces ``--steps`` more steps after a warmup and prints
one JSON line: the untraced ms/step of every run, the traced ms/step, the
device's busy ms per step (the sum of its kernels' times) and busy share,
the top kernels' device ms per step, and the host-side aten ops per step.
The loop is the one ``run`` and ``bench`` pick (``uses_lazy``) unless
``--eager``; ``--partition slab`` profiles the distributed slab step on a
one-rank NCCL group instead (``run_slab_benchmark``'s splash run).  The
host ops are also listed by name (the most frequent, per step).  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType


def profile(scene: str, overrides: dict, backend: str, lazy: bool,
            steps: int, warmup: int, top: int = 8) -> dict:
    """Trace ``steps`` steps of the single-device loop after ``warmup``."""
    from ..models import make_scene
    from ..ops.lazy import drive_loop_lazy
    from ..ops.step import drive_loop
    from .benchmark import resolve_sweep_settings

    cfg, state = make_scene(scene, device="cuda", **overrides)
    cfg = resolve_sweep_settings(cfg, state, overrides)
    if lazy:
        carry, _ = drive_loop_lazy(cfg, state, warmup, keep_carry=True)

        def run():
            return drive_loop_lazy(cfg, None, steps, carry=carry,
                                   keep_carry=True)
    else:
        state, _ = drive_loop(cfg, state, warmup, backend=backend)

        def run():
            return drive_loop(cfg, state, steps, backend=backend)
    return _trace(run, steps, top)


def profile_slab(overrides: dict, steps: int, warmup: int,
                 top: int = 8) -> dict:
    """Trace ``steps`` slab steps on a one-rank NCCL group after
    ``warmup`` (the splash run of ``run_slab_benchmark``)."""
    from ..parallel import comm, slabs
    from .benchmark import slab_setup

    ov = dict(overrides)
    n = ov.pop("num_particles")
    cfg, state, zsplit, caps, sub_len = slab_setup(n, ov, 1.05,
                                                   torch.device("cuda"))
    with comm.local_group("cuda") as group:
        step = slabs.make_slab_step(cfg, group, *caps, sweeps="pallas",
                                    zsplit=zsplit, sub_len=sub_len)
        carry = [slabs.distribute(cfg, state, group, caps[0], zsplit)]
        for _ in range(warmup):
            carry[0], _ = step(carry[0])

        def run():
            for _ in range(steps):
                carry[0], _ = step(carry[0])
        return _trace(run, steps, top)


def _trace(run, steps: int, top: int) -> dict:
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel names cut to 80 characters; kernels sharing a cut name add up
    us, calls = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us[e.key[:80]] = us.get(e.key[:80], 0.0) + e.self_device_time_total
            calls[e.key[:80]] = calls.get(e.key[:80], 0) + e.count
    busy_us = sum(us.values())
    names = sorted(us, key=us.get, reverse=True)[:top]
    host = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CPU and e.cpu_parent is None
                and e.name.startswith("aten::")):
            host[e.name] = host.get(e.name, 0) + 1
    host_ops = sum(host.values())
    host_top = sorted(host, key=host.get, reverse=True)[:top]
    return {
        "traced_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels_ms_per_step": {k: us[k] / 1e3 / steps for k in names},
        "top_kernel_calls_per_step": {k: calls[k] / steps for k in names},
        "host_aten_ops_per_step": host_ops / steps,
        "top_host_ops_per_step": {k: host[k] / steps for k in host_top},
    }


def main(argv: list[str] | None = None) -> int:
    from ..__main__ import _overrides
    from .benchmark import run_benchmark, run_slab_benchmark

    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.utils."
             "profile_step")
    ap.add_argument("--scene", default="splash")
    ap.add_argument("-n", "--num-particles", type=int, default=1_000_000)
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "celllist", "pairwise"])
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--set", action="append", metavar="KEY=VALUE")
    ap.add_argument("--partition", default="single", choices=["single", "slab"],
                    help="slab = the slab step on a one-rank group (splash)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    ov = _overrides(args)
    if args.partition == "slab":
        slab_ov = {k: v for k, v in ov.items() if k != "num_particles"}
        runs = [run_slab_benchmark(n=args.num_particles, steps=args.steps,
                                   warmup=args.warmup, overrides=slab_ov)
                for _ in range(args.repeats)]
        traced = profile_slab(ov, args.steps, args.warmup)
        lazy = True
    else:
        runs = [run_benchmark(scene=args.scene,
                              lazy=False if args.eager else None,
                              steps=args.steps, warmup=args.warmup,
                              overrides=ov, backend=args.backend)
                for _ in range(args.repeats)]
        lazy = runs[0]["lazy"]
        traced = profile(args.scene, ov, args.backend, lazy, args.steps,
                         args.warmup)
    rec = {"scene": args.scene, "partition": args.partition, "overrides": ov,
           "backend": args.backend, "lazy": lazy, "steps": args.steps,
           "untraced_ms_per_step": [r["ms_per_step"] for r in runs],
           **traced, "device": torch.cuda.get_device_name(0)}
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
