"""Command line: ``python -m smoothed_particle_hydrodynamics_tpu_torch``.

    run   [--scene S] [-n N] [--steps K] [--block B] [--out DIR] ...
    bench [--scene S] [-n N] [--steps K] [--warmup W]   one JSON line
    sweep [--scene S] [--viscosity MUS] [--stiffness KS] [--out F.json]
    info  [--scene S] [-n N] [--set KEY=VALUE]           the resolved config
    watch [--out DIR] [--once]                           a run's dashboard

The flags and defaults are the JAX CLI's (``cli.py``).  ``--scene`` is one
of disk (default), dam_break, splash, honey, dam_break_10m; ``-n`` and
``--seed`` default to the scene's own size and seed (disk 32,768 and 42,
dam_break 100k and 7, splash 1M and 11).

``run`` steps ``cfg.num_steps + 1`` steps (the reference's headless run) in
blocks of 50 and writes, under ``--out`` (default ``out``), the reference's
``energy.txt``, ``angularmomentum.txt``, ``timing.txt`` and
``neighbors.txt``, one ``diagnostics.jsonl`` record per step, ``run.json``
(the config, its fingerprint, the scene, backend, lazy driver, device name
and ``--profile-phases`` times) and ``final_state.npz``.  It prints the
banner, one ``step k/total`` line per block (none with ``--quiet``) and a
``done:`` line.  ``--checkpoint-every K`` saves ``ckpt_<step>.npz`` under
``--checkpoint-dir`` (default ``checkpoints``) at the first block boundary
of every K steps; ``--resume`` starts from the newest one there, with its
config.  ``--apply STEP:KEY=VALUE`` (repeatable) changes a config field at
that step: the block before it ends there, and the lazy driver rebins from
the current state.  A JSON object of config fields dropped at
``<out>/apply.json`` lands at the next block boundary, and the file is
renamed ``.applied`` (or ``.rejected``).  SIGINT saves a checkpoint at the
end of the block and exits 130; SIGUSR1 pauses and resumes at block
boundaries; the caller's handlers come back when ``run`` returns.  A
non-finite energy saves a checkpoint and exits 2; dropped interactions
(``truncated_ranges``) print one warning.  ``--lazy/--no-lazy`` forces the
driver (default: the lazy loop for the pallas backend in the sublane
layout, unless ``second_kick=full``); ``--scan-block`` is accepted and
changes nothing here (the steps run one by one either way).

``sweep`` runs a viscosity x stiffness grid (default 200 steps a cell) and
prints one JSON record per cell and a table; ``info`` prints the resolved
config's JSON without drawing the particles; ``watch`` repaints sparklines
of energy drift, |L|, step time and neighbor counts from
``<out>/diagnostics.jsonl``.

``bench`` times 100 steps after 10 warmup steps; ``bench --partition slab``
times the distributed slab engine (``parallel/slabs.py``) on a one-rank
group of the device with the splash scene (1M particles unless ``-n``).

``--backend`` is ``auto`` (default: pallas on cuda, celllist on cpu),
``pallas``, ``celllist`` or ``pairwise``.  ``--device`` defaults to cuda,
and a command without a CUDA device stops with an error; ``--device cpu``
runs the kernels' plain twins on the CPU.  ``--set key=value`` overrides a
config field, the value parsed as JSON (a list becomes a tuple; a value
that is not JSON stays a string) and an unknown field refused; capped mode
is ``--set capped_candidates=4`` (``--set capped_fused=true`` for the fused
sweep); ``pallas_window_t=0`` derives the sublane window and
``range_slice=0`` the cell-list slice from the scene.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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


def _fields() -> set[str]:
    from .config import SphConfig

    return {f.name for f in dataclasses.fields(SphConfig)}


def _overrides(args) -> dict:
    """Config overrides: ``num_particles`` only when ``-n`` is given, and
    every ``--set``; a key that is not a config field stops the CLI."""
    fields = _fields()
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


def _applies(specs: list[str]) -> dict[int, dict]:
    """``--apply STEP:KEY=VALUE`` specs -> {step: {key: value}}."""
    fields = _fields()
    pending: dict[int, dict] = {}
    for spec in specs:
        at, _, kv = spec.partition(":")
        key, _, value = kv.partition("=")
        if key not in fields:
            raise SystemExit(f"--apply: unknown config field {key!r}")
        pending.setdefault(int(at), {})[key] = _value(value)
    return pending


def _read_apply(path: str, cfg):
    """The config with ``<out>/apply.json``'s fields applied, and the
    fields; raises ValueError on a payload that is not a JSON object of
    config fields or gives an invalid config."""
    with open(path) as fh:
        payload = json.load(fh)
    if not isinstance(payload, dict):
        raise ValueError("apply.json must hold a JSON object")
    fields = _fields()
    unknown = [k for k in payload if k not in fields]
    if unknown:
        raise ValueError(f"unknown config fields: {unknown}")
    new = cfg.replace(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in payload.items()})
    new.validate()
    return new, payload


class _Signals:
    """SIGINT: checkpoint at the end of the block and stop; SIGUSR1: pause
    or resume at block boundaries.  The handlers that were installed before
    come back on exit."""

    def __init__(self):
        self.interrupted = False
        self.paused = False
        self._previous = {}

    def _on_sigint(self, signum, frame):
        self.interrupted = True
        print("\ninterrupt: will checkpoint at the end of this block...",
              file=sys.stderr)

    def _on_sigusr1(self, signum, frame):
        self.paused = not self.paused
        print("\npaused — SIGUSR1 again to resume" if self.paused
              else "\nresumed", file=sys.stderr)

    def __enter__(self):
        import signal

        handlers = {signal.SIGINT: self._on_sigint}
        if hasattr(signal, "SIGUSR1"):
            handlers[signal.SIGUSR1] = self._on_sigusr1
        for sig, fn in handlers.items():
            self._previous[sig] = signal.signal(sig, fn)
        return self

    def __exit__(self, *exc):
        import signal

        for sig, fn in self._previous.items():
            signal.signal(sig, signal.SIG_DFL if fn is None else fn)


def cmd_run(args) -> int:
    from .models import scene_config
    from .ops.lazy import drive_loop_lazy, unsort_carry
    from .ops.step import drive_loop
    from .utils import benchmark
    from .utils import io as ckpt_io
    from .utils.diagnostics import (DiagnosticsWriter, detect_blowup,
                                    detect_truncation)

    dev = _device(args.device)
    backend = _backend(args.backend, dev)
    overrides = _overrides(args)
    if args.resume:
        path = ckpt_io.latest_checkpoint(args.checkpoint_dir)
        if path is None:
            raise SystemExit(
                f"--resume: no checkpoint under {args.checkpoint_dir}")
        start_step, given, state = ckpt_io.load_checkpoint(path, dev)
        print(f"resumed from {path} at step {start_step}")
        cfg = benchmark.resolve_sweep_settings(given, state, overrides,
                                               backend)
        cfg.validate()
    else:
        start_step = 0
        given = scene_config(args.scene, **overrides)
        cfg, state = benchmark.resolve_scene(args.scene, dev, overrides,
                                             args.seed, backend)
    for name in ("pallas_window_t", "capped_sub_len", "range_slice"):
        if getattr(given, name) == 0 and getattr(cfg, name):
            print(f"derived {name}={getattr(cfg, name)}")
    lazy = (benchmark.uses_lazy(cfg, backend) if args.lazy is None
            else args.lazy)
    if lazy and backend != "pallas":
        # the lazy driver always runs the sublane sweeps
        raise SystemExit(f"--lazy drives the pallas sweeps; got --backend "
                         f"{backend}")
    total = cfg.num_steps + 1 if args.steps is None else args.steps

    # the lazy driver's carry between blocks (None: the next block bins
    # ``state`` afresh); ``state`` is brought up to date from it only where
    # it is read: a checkpoint, an apply, the end
    carry = None

    def advance(n):
        nonlocal state, carry
        if not lazy:
            state, diags = drive_loop(cfg, state, n, backend=backend)
            return diags
        carry, diags = drive_loop_lazy(cfg, state if carry is None else None,
                                       n, carry=carry, keep_carry=True,
                                       scan_block=args.scan_block)
        return diags

    def current():
        """The state in the caller's particle order."""
        nonlocal state
        if carry is not None:
            state = unsort_carry(carry)
        return state

    def rebuild(new_cfg):
        """An applied config: the next block rebins from the current state
        under it (the JAX CLI's fresh ``make_run``)."""
        nonlocal cfg, carry
        new_cfg.validate()
        current()
        cfg, carry = new_cfg, None

    pending = _applies(args.apply)
    with _Signals() as signals:
        print(f"scene={args.scene} n={cfg.num_particles} steps={total} "
              f"backend={backend} devices=[{dev}]", flush=True)
        phase_ms = {}
        if args.profile_phases:
            from .utils.profiling import profile_phases

            phase_ms = profile_phases(cfg, state)
            print("per-phase [ms]: " + "  ".join(
                f"{k}={v:.2f}" for k, v in phase_ms.items()))
        truncation_warned = False
        with DiagnosticsWriter(args.out) as writer:
            ckpt_io.write_run_metadata(args.out, cfg, {
                "scene": args.scene, "backend": backend,
                "phase_ms": phase_ms, "lazy": lazy,
                "device": benchmark._device_name(dev)})
            done = start_step
            t_start = time.perf_counter()
            apply_path = os.path.join(args.out, "apply.json")
            while done < total:
                due = sorted(k for k in pending if k <= done)
                if due:
                    merged = {}
                    for k in due:
                        merged.update(pending.pop(k))
                    rebuild(cfg.replace(**merged))
                    print(f"applied at step {done}: "
                          + ", ".join(f"{k}={v}" for k, v in merged.items()))
                if os.path.exists(apply_path):
                    try:
                        cfg_new, payload = _read_apply(apply_path, cfg)
                    except (OSError, ValueError, TypeError) as e:
                        os.replace(apply_path, apply_path + ".rejected")
                        print(f"apply.json rejected at step {done}: {e}",
                              file=sys.stderr)
                    else:
                        rebuild(cfg_new)
                        os.replace(apply_path, apply_path + ".applied")
                        print(f"applied at step {done} (apply.json): "
                              + ", ".join(f"{k}={v}"
                                          for k, v in payload.items()))
                while signals.paused and not signals.interrupted:
                    time.sleep(0.2)   # paused in place; state stays put
                nblock = min(args.block, total - done)
                if pending:
                    upcoming = min(k for k in pending if k > done)
                    nblock = min(nblock, max(upcoming - done, 1))
                t0 = time.perf_counter()
                diags = advance(nblock)
                _sync(dev)
                dt_ms = (time.perf_counter() - t0) * 1000.0 / nblock
                host = writer.write_block(done, diags,
                                          dict(phase_ms, step=dt_ms))
                bad, why = detect_blowup(host)
                if bad:
                    ckpt_io.save_checkpoint(args.checkpoint_dir,
                                            done + nblock, cfg, current())
                    print(f"ABORT at step {done + nblock}: {why} "
                          "(checkpoint saved)", file=sys.stderr)
                    return 2
                lossy, what = detect_truncation(host)
                if lossy and not truncation_warned:
                    truncation_warned = True
                    print(f"WARNING at step {done + nblock}: {what} — "
                          "interactions are being dropped", file=sys.stderr)
                done += nblock
                if signals.interrupted:
                    p = ckpt_io.save_checkpoint(args.checkpoint_dir, done,
                                                cfg, current())
                    print(f"interrupted at step {done}; checkpoint saved "
                          f"to {p}")
                    return 130
                if args.checkpoint_every and (
                        done % args.checkpoint_every) < nblock:
                    ckpt_io.save_checkpoint(args.checkpoint_dir, done, cfg,
                                            current())
                if not args.quiet:
                    pps = cfg.num_particles * nblock / max(
                        time.perf_counter() - t0, 1e-9)
                    print(f"step {done}/{total}  {dt_ms:.2f} ms/step  "
                          f"{pps:.3e} particle-steps/s")
            elapsed = time.perf_counter() - t_start
        ckpt_io.save_state(os.path.join(args.out, "final_state.npz"),
                           current())
        print(f"done: {total - start_step} steps in {elapsed:.1f}s; "
              f"diagnostics in {args.out}/")
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


def cmd_sweep(args) -> int:
    """Viscosity x stiffness regime sweep (the JAX CLI's, ``cli.py:473``):
    each grid cell runs ``--steps`` steps and reports the blow-up step (if
    any), the relative energy drift and the mean neighbor count.  One JSON
    line per cell, then a table; ``--out`` writes the records."""
    import itertools

    import numpy as np

    from .ops.lazy import drive_loop_lazy
    from .ops.step import drive_loop
    from .utils.benchmark import resolve_scene, uses_lazy
    from .utils.diagnostics import detect_blowup, host_diagnostics

    dev = _device(args.device)
    backend = _backend(args.backend, dev)
    overrides = _overrides(args)
    mus = [float(x) for x in args.viscosity.split(",")]
    ks = [float(x) for x in args.stiffness.split(",")]
    rows = []
    for mu, k in itertools.product(mus, ks):
        cfg, state = resolve_scene(args.scene, dev, {
            **overrides, "viscosity": mu, "stiffness": k}, backend=backend)
        lazy = uses_lazy(cfg, backend)
        done, blowup_step = 0, None
        e0 = e_last = nmean = None
        carry, st = None, state
        while done < args.steps and blowup_step is None:
            nblock = min(args.block, args.steps - done)
            if lazy:
                carry, diags = drive_loop_lazy(cfg, st, nblock, carry=carry,
                                               keep_carry=True)
            else:
                st, diags = drive_loop(cfg, st, nblock, backend=backend)
            host = host_diagnostics(diags)
            tot = host.kinetic_energy + host.potential_energy
            if e0 is None:
                e0 = float(tot[0])
            e_last = float(tot[-1])
            nmean = float(host.neighbor_mean[-1])
            bad, _ = detect_blowup(host)
            if bad:
                off = (int(np.argmax(~np.isfinite(tot)))
                       if (~np.isfinite(tot)).any() else nblock - 1)
                blowup_step = done + off
            done += nblock
        drift = (abs(e_last - e0) / max(abs(e0), 1e-30)
                 if blowup_step is None else float("nan"))
        row = {"viscosity": mu, "stiffness": k, "steps": done,
               "blowup_step": blowup_step, "energy_drift": drift,
               "neighbor_mean": nmean, "stable": blowup_step is None}
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(f"\n{args.scene} n={overrides.get('num_particles', 'default')} "
          f"steps={args.steps} backend={backend}")
    print(f"{'viscosity':>10} {'stiffness':>10} {'stable':>7} "
          f"{'blowup@':>8} {'E-drift':>10} {'nmean':>7}")
    for r in rows:
        print(f"{r['viscosity']:>10g} {r['stiffness']:>10g} "
              f"{str(r['stable']):>7} "
              f"{str(r['blowup_step'] or '-'):>8} "
              f"{r['energy_drift']:>10.3g} {r['neighbor_mean']:>7.2f}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=2)
        print(f"wrote {args.out}")
    return 0


def cmd_info(args) -> int:
    from .models import scene_config

    print(scene_config(args.scene, **_overrides(args)).to_json())
    return 0


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(vals, width: int = 48) -> str:
    """The last ``width`` values as a unicode sparkline (a constant series
    is ▁); a non-finite value is the top glyph, so ``watch`` keeps working
    on a run that blew up."""
    vals = list(vals)[-width:]
    if not vals:
        return ""
    finite = [v for v in vals if math.isfinite(v)]
    if not finite:
        return _SPARK[-1] * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    if span <= 0:
        return "".join(_SPARK[-1] if not math.isfinite(v) else _SPARK[0]
                       for v in vals)
    return "".join(_SPARK[-1] if not math.isfinite(v)
                   else _SPARK[min(int((v - lo) / span * 8), 7)]
                   for v in vals)


def _dashboard(out: str, rows: list, idle: bool) -> list[str]:
    r = rows[-1]
    e0 = rows[0]["total_energy"]
    drift = [(x["total_energy"] - e0) / abs(e0)
             if (e0 and math.isfinite(e0)) else 0.0 for x in rows]
    lines = [
        f"watch {out}  step {r['step']}  {r['step_ms']:.2f} ms/step  "
        f"rows {len(rows)}" + ("  (idle)" if idle else ""),
        f"E_total {r['total_energy']:.6e}  drift {drift[-1]:+.3e}  "
        f"{_sparkline(drift)}",
        f"|L|     {r['angular_momentum']:.6e}  "
        f"{_sparkline([x['angular_momentum'] for x in rows])}",
        f"step_ms {r['step_ms']:8.2f}       "
        f"{_sparkline([x['step_ms'] for x in rows])}",
        f"nbr mean {r['neighbor_mean']:7.2f}  max {r['neighbor_max']}  "
        f"min {r['neighbor_min']}  "
        f"{_sparkline([x['neighbor_mean'] for x in rows])}",
    ]
    bad = {k: r[k] for k in ("overflow_cells", "truncated_ranges",
                             "halo_dropped", "migration_dropped")
           if r.get(k)}
    if bad:
        lines.append("WARN " + "  ".join(f"{k}={v}" for k, v in bad.items()))
    return lines


def cmd_watch(args) -> int:
    """Terminal dashboard over a run's ``diagnostics.jsonl`` (the JAX CLI's
    ``watch``): repaints every ``--interval`` seconds, reading only the
    bytes appended since the last tick; ``--once`` prints one snapshot."""
    path = os.path.join(args.out, "diagnostics.jsonl")
    last_n, rows, offset = 0, [], 0
    try:
        while True:
            try:
                with open(path) as fh:
                    fh.seek(offset)
                    chunk = fh.read()
            except FileNotFoundError:
                if args.once:
                    print(f"no diagnostics at {path}", file=sys.stderr)
                    return 1
                time.sleep(args.interval)
                continue
            # complete lines only: a row still being written waits
            complete, sep, _ = chunk.rpartition("\n")
            offset += len((complete + sep).encode())
            for ln in complete.splitlines():
                ln = ln.strip()
                if ln:
                    try:
                        rows.append(json.loads(ln))
                    except json.JSONDecodeError:
                        pass  # a torn row
            if rows:
                prefix = "" if args.once else "\x1b[2J\x1b[H"
                print(prefix + "\n".join(
                    _dashboard(args.out, rows, len(rows) <= last_n)),
                    flush=True)
                last_n = len(rows)
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
        return 0


def _scene_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="disk")
    p.add_argument("-n", "--num-particles", type=int, default=None,
                   help="default: the scene's own size")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pallas", "celllist", "pairwise"],
                   help="auto = pallas on cuda, celllist on cpu")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "bench", "sweep", "info"):
        p = sub.add_parser(name)
        _scene_flags(p)
        if name != "info":
            p.add_argument("--device", default="cuda")
        if name in ("run", "bench"):
            p.add_argument("--steps", type=int, default=None,
                           help="run: default cfg.num_steps + 1; bench: 100")
            p.add_argument("--seed", type=int, default=None,
                           help="default: the scene's own seed")
    p = sub.choices["run"]
    p.add_argument("--block", type=int, default=50)
    p.add_argument("--out", default="out")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--apply", action="append", default=[],
                   metavar="STEP:KEY=VALUE",
                   help="change a config field at a step boundary "
                        "(repeatable), e.g. --apply 500:viscosity=0.1")
    p.add_argument("--lazy", action=argparse.BooleanOptionalAction,
                   default=None, help="lazy rebinning driver (default: on "
                   "for the sublane pallas backend)")
    p.add_argument("--scan-block", type=int, default=0,
                   help="accepted for the JAX CLI; changes nothing here")
    p.add_argument("--profile-phases", action="store_true",
                   help="time the step's phases once (timing.txt columns)")
    p.add_argument("--quiet", action="store_true")
    p = sub.choices["bench"]
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--eager", action="store_true",
                   help="rebin every step (ops.step)")
    p.add_argument("--partition", default="single",
                   choices=["single", "slab"],
                   help="slab = the distributed slab engine on a one-rank "
                        "group (the splash scene)")
    p.add_argument("--slab-sweeps", default="pallas",
                   choices=["pallas", "celllist"])
    p.add_argument("--scan-block", type=int, default=0,
                   help="slab steps per call (0 = 1)")
    p = sub.choices["sweep"]
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--block", type=int, default=50)
    p.add_argument("--viscosity", default="0.01,0.1,1,10",
                   help="comma-separated mu grid")
    p.add_argument("--stiffness", default="1e-4,1e-3,1e-2",
                   help="comma-separated k grid")
    p.add_argument("--out", default="",
                   help="write the sweep records to this JSON file")
    p = sub.add_parser("watch")
    p.add_argument("--out", default="out", help="run output directory")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "bench": cmd_bench, "sweep": cmd_sweep,
            "info": cmd_info, "watch": cmd_watch}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
