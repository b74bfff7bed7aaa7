"""Command line: ``python -m smoothed_particle_hydrodynamics_tpu_torch``.

    run   --scene splash -n N --steps S [--block B]   one JSON line per block
    bench --scene splash -n N --steps S [--warmup W]  one JSON line

Both drive the lazy-rebinning loop on ``--device`` (default: cuda when
present, else cpu with the kernels' plain twins).  ``--set key=value``
overrides a config field (e.g. ``--set cell_size_factor=1.25``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def _value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v.lower(), v)


def _overrides(args) -> dict:
    ov = {"num_particles": args.num_particles}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        ov[k] = _value(v)
    return ov


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_run(args) -> int:
    from .models import make_scene
    from .ops.lazy import drive_loop_lazy

    dev = torch.device(args.device)
    cfg, state = make_scene(args.scene, device=dev, seed=args.seed,
                            **_overrides(args))
    carry, done = None, 0
    while done < args.steps:
        k = min(args.block, args.steps - done)
        t0 = time.perf_counter()
        carry, d = drive_loop_lazy(cfg, state if carry is None else None, k,
                                   carry=carry, keep_carry=True)
        _sync(dev)
        dt = time.perf_counter() - t0
        done += k
        print(json.dumps({
            "step": done,
            "ms_per_step": dt * 1000.0 / k,
            "particle_steps_per_s": cfg.num_particles * k / dt,
            "kinetic_energy": d.kinetic_energy[-1].item(),
            "potential_energy": d.potential_energy[-1].item(),
            "angular_momentum": d.angular_momentum[-1].item(),
            "neighbor_mean": d.neighbor_mean[-1].item(),
            "neighbor_min": d.neighbor_min[-1].item(),
            "neighbor_max": d.neighbor_max[-1].item(),
            "rebin_count": carry.rebin_count,
            "device": str(dev),
        }), flush=True)
    return 0


def cmd_bench(args) -> int:
    from .utils.benchmark import run_benchmark

    r = run_benchmark(scene=args.scene, lazy=not args.eager, steps=args.steps,
                      warmup=args.warmup, overrides=_overrides(args),
                      device=args.device, seed=args.seed)
    print(json.dumps(r))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m smoothed_particle_hydrodynamics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "bench"):
        p = sub.add_parser(name)
        p.add_argument("--scene", default="splash")
        p.add_argument("-n", "--num-particles", type=int, default=1_000_000)
        p.add_argument("--steps", type=int, default=20)
        p.add_argument("--seed", type=int, default=11)
        p.add_argument("--device",
                       default="cuda" if torch.cuda.is_available() else "cpu")
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
    sub.choices["run"].add_argument("--block", type=int, default=10)
    sub.choices["bench"].add_argument("--warmup", type=int, default=3)
    sub.choices["bench"].add_argument("--eager", action="store_true",
                                      help="rebin every step (ops.step)")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "bench": cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
