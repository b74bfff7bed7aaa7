"""Command line: ``python -m smoothed_particle_hydrodynamics_tpu_torch``.

    run   --scene S [-n N] --steps K [--block B]   one JSON line per block
    bench --scene S [-n N] --steps K [--warmup W]  one JSON line

``--scene`` is one of disk (default), dam_break, splash, honey,
dam_break_10m.  The defaults are the JAX CLI's (``cli.py:27``, ``:130``,
``:743-746``, ``:467``, ``:797-798``): ``run`` steps ``cfg.num_steps + 1``
of the resolved config in blocks of 50, ``bench`` times 100 steps after 10
warmup steps.  As in the JAX CLI, ``-n`` and ``--seed`` default to the
scene's own size and seed (disk 32,768 and 42, dam_break 100k and 7,
splash 1M and 11), and ``run`` and ``bench`` validate the resolved config
(``SphConfig.validate``) before any step.  ``bench --partition slab`` times
the distributed slab engine instead (``parallel/slabs.py``) on a one-rank
group of the device, with the splash scene (1M particles unless ``-n``;
bench.py's ``slab_1dev`` row; ``--set capped_candidates=4 --set
pallas_block_t=256 --set pallas_window_t=0`` is its ``slab_capped_k4``
row).  ``--backend`` is ``auto`` (default: pallas on cuda, celllist on
cpu), ``pallas``, ``celllist`` or ``pairwise``.  As in the JAX
CLI, the lazy-rebinning loop drives the pallas backend in the sublane
layout (unless ``second_kick=full`` or ``bench --eager``); every other
choice runs the eager loop, which rebins every step.  ``--device`` defaults
to cuda, and a run without a CUDA device stops with an error; ``--device
cpu`` runs the kernels' plain twins on the CPU.  ``--set key=value``
overrides a config field, the value parsed as JSON (a list becomes a
tuple; a value that is not JSON stays a string) and an unknown field
refused (e.g. ``--set cell_size_factor=1.25``,
``--set pallas_layout=lane``); capped mode is ``--set capped_candidates=4``
(``--set capped_fused=true`` for the fused sweep); ``pallas_window_t=0``
derives the sublane window and ``range_slice=0`` the cell-list slice from
the scene.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch


def _value(v: str):
    """A ``--set`` value: JSON (numbers, true/false, null, lists as tuples),
    else the raw string (the JAX CLI's ``_apply_overrides``)."""
    try:
        x = json.loads(v)
    except json.JSONDecodeError:
        return v
    return tuple(x) if isinstance(x, list) else x


def _overrides(args) -> dict:
    """Config overrides: ``num_particles`` only when ``-n`` is given, and
    every ``--set``; a key that is not a config field stops the CLI."""
    from .config import SphConfig

    fields = {f.name for f in dataclasses.fields(SphConfig)}
    ov = ({} if args.num_particles is None
          else {"num_particles": args.num_particles})
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        if k not in fields:
            raise SystemExit(f"unknown config field: {k}")
        ov[k] = _value(v)
    return ov


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(--device cpu runs the kernels' plain twins)")
    return dev


def _backend(name: str, dev: torch.device) -> str:
    """``auto`` = the kernels on the card, the cell-list sweeps on the CPU
    (the JAX CLI's rule, ``cli.py:41-55``)."""
    if name != "auto":
        return name
    return "pallas" if dev.type == "cuda" else "celllist"


def cmd_run(args) -> int:
    from .ops.lazy import drive_loop_lazy
    from .ops.step import drive_loop
    from .utils.benchmark import resolve_scene, uses_lazy

    dev = _device(args.device)
    backend = _backend(args.backend, dev)
    cfg, state = resolve_scene(args.scene, dev, _overrides(args), args.seed)
    lazy = uses_lazy(cfg, backend)
    total = cfg.num_steps + 1 if args.steps is None else args.steps
    carry, done, rebins = None, 0, total
    while done < total:
        k = min(args.block, total - done)
        t0 = time.perf_counter()
        if lazy:
            carry, d = drive_loop_lazy(cfg, state if carry is None else None,
                                       k, carry=carry, keep_carry=True)
            rebins = carry.rebin_count
        else:
            state, d = drive_loop(cfg, state, k, backend=backend)
            rebins = done + k
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
            "truncated_ranges": int(d.truncated_ranges.max().item()),
            "overflow_cells": int(d.overflow_cells.max().item()),
            "rebin_count": rebins,
            "backend": backend,
            "lazy": lazy,
            "window_t": cfg.pallas_window_t,
            "block_t": cfg.pallas_block_t,
            "capped_sub_len": cfg.capped_sub_len,
            "device": str(dev),
        }), flush=True)
    return 0


def cmd_bench(args) -> int:
    from .utils.benchmark import run_benchmark, run_slab_benchmark

    dev = _device(args.device)
    if args.partition == "slab":
        ov = _overrides(args)
        n = ov.pop("num_particles", 1_000_000)
        r = run_slab_benchmark(n=n, steps=args.steps or 100,
                               warmup=args.warmup, sweeps=args.slab_sweeps,
                               overrides=ov, scan_block=args.scan_block,
                               device=str(dev), seed=args.seed)
        print(json.dumps(r))
        return 0
    r = run_benchmark(scene=args.scene, lazy=False if args.eager else None,
                      steps=args.steps or 100, warmup=args.warmup,
                      overrides=_overrides(args), device=str(dev),
                      seed=args.seed, backend=_backend(args.backend, dev))
    print(json.dumps(r))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m smoothed_particle_hydrodynamics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "bench"):
        p = sub.add_parser(name)
        p.add_argument("--scene", default="disk")
        p.add_argument("-n", "--num-particles", type=int, default=None,
                       help="default: the scene's own size")
        p.add_argument("--steps", type=int, default=None,
                       help="run: default cfg.num_steps + 1; bench: 100")
        p.add_argument("--seed", type=int, default=None,
                       help="default: the scene's own seed")
        p.add_argument("--device", default="cuda")
        p.add_argument("--backend", default="auto",
                       choices=["auto", "pallas", "celllist", "pairwise"],
                       help="auto = pallas on cuda, celllist on cpu")
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
    sub.choices["run"].add_argument("--block", type=int, default=50)
    sub.choices["bench"].add_argument("--warmup", type=int, default=10)
    sub.choices["bench"].add_argument("--eager", action="store_true",
                                      help="rebin every step (ops.step)")
    sub.choices["bench"].add_argument(
        "--partition", default="single", choices=["single", "slab"],
        help="slab = the distributed slab engine on a one-rank group "
             "(the splash scene)")
    sub.choices["bench"].add_argument("--slab-sweeps", default="pallas",
                                      choices=["pallas", "celllist"])
    sub.choices["bench"].add_argument("--scan-block", type=int, default=0,
                                      help="slab steps per call (0 = 1)")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "bench": cmd_bench}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
