"""Command line: ``python -m smoothed_particle_hydrodynamics_tpu_torch``.

    run   [--scene S] [-n N] [--steps K] [--block B] [--out DIR] ...
    bench [--scene S] [-n N] [--steps K] [--warmup W] [--lazy|--no-lazy]
                                                        one JSON line
    sweep [--scene S] [--viscosity MUS] [--stiffness KS] [--out F.json]
    info  [--scene S] [-n N] [--set KEY=VALUE]           the resolved config
    watch [--out DIR] [--once]                           a run's dashboard
    render STATE.npz [-o F.png] [--perspective] [--camera AZ,EL,DIST]
          [--no-box] [--voxels]                          a state as a PNG
    parity GOLDEN_DIR [--steps K] [--cell-capacity C]    compat vs dumps

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
boundaries; the caller's handlers come back when ``run`` returns.
``--render`` collects a frame every ``--render-every`` steps (at block
boundaries) and writes ``<out>/sph_anim.gif`` at the end; ``--live PATH``
swaps a PNG of the current state into PATH every block (atomic
``os.replace``); ``--live-term`` repaints the splat in the terminal every
block.  A lazy run renders from its sorted carry (the splat does not depend
on particle order), so no block unsorts for a frame.  ``--exact-ic``
starts the disk from the reference's srand(42) state.  A
non-finite energy saves a checkpoint and exits 2; dropped interactions
(``truncated_ranges``) print one warning.  ``--lazy/--no-lazy`` forces the
driver (default: the lazy loop for the pallas backend in the sublane
layout, unless ``second_kick=full``); ``--scan-block`` is accepted and
changes nothing here (the steps run one by one either way).

``run --devices N`` (N > 1) runs on N ranks (``parallel.make_mesh``:
NCCL with rank r on ``cuda:r`` when there are N cards, else gloo ranks
sharing the cards round-robin, or on the CPU with ``--device cpu``), named
in the banner as ``devices=[cuda:0, cuda:0] comm=gloo`` and recorded in
``run.json`` (``devices``, ``comm``, ``partition``).  The ranks are one
``parallel.RankPool`` for the whole run: they hold the state, and the
blocks, applies, checkpoints and pictures are commands to them; the state
crosses to this process only where it is read.  ``--partition slab``
(default) is the distributed slab engine (``--backend`` celllist or
pallas; its split, capped sub-frame bound and capacities derived from the
state); after every block but the last, ``--rebalance-threshold T``
(default 1.5, 0 = off) re-partitions when the ranks' max/mean particle
count exceeds T.  ``--partition halo`` is the row-sharded step with
replicated binning (``parallel/sharding.py``, celllist only; ``auto``
resolves to it).

``sweep`` runs a viscosity x stiffness grid (default 200 steps a cell) and
prints one JSON record per cell and a table; ``info`` prints the resolved
config's JSON without drawing the particles; ``watch`` repaints sparklines
of energy drift, |L|, step time and neighbor counts from
``<out>/diagnostics.jsonl``.

``bench`` times 100 steps after 10 warmup steps and prints the record of
``utils.benchmark.run_benchmark``; ``--lazy/--no-lazy`` forces the driver
as in the JAX CLI (default: the lazy loop for the pallas backend in the
sublane layout, unless ``compat`` or ``second_kick=full``; ``--lazy`` with
another backend is refused), and ``--eager`` is ``--no-lazy``.
``bench --partition slab``
times the distributed slab engine (``parallel/slabs.py``) on a one-rank
group of the device with the splash scene (1M particles unless ``-n``).

``render`` draws a saved state (a checkpoint or ``final_state.npz``) under
the scene's config: the orthographic x-z splat, ``--voxels`` with the
occupied cells in red, or ``--perspective`` (``--camera`` implies it; the
box outline unless ``--no-box``).  ``parity`` steps the compat pipeline from
the first ``state_*.bin`` dump of a directory written by
``tools/golden_main.cpp`` and prints each later dump's density and position
rel-L2 and neighbor-count match; it exits 1 when the worst density rel-L2
is above 1e-3.

``--backend`` is ``auto`` (default: pallas on cuda, celllist on cpu; with
``--compat``, compat), ``pallas``, ``celllist``, ``pairwise`` or
``compat`` (the C++ reference's quirks, ``compat/``; ``--compat`` sets
``cfg.compat``, which every backend but pairwise runs as compat).  ``--device`` defaults to cuda,
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
    if getattr(args, "compat", False):
        ov["compat"] = True
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


def _backend(name: str, dev: torch.device, compat: bool = False,
             devices: int = 0, partition: str = "slab") -> str:
    """``auto`` = compat with ``--compat``, the cell-list sweeps on
    ``--devices N --partition halo`` (the halo-sharded step has no other),
    else the kernels on the card and the cell-list sweeps on the CPU (the
    JAX CLI's rule, ``cli.py:41-55``)."""
    if name != "auto":
        return name
    if compat:
        return "compat"
    if devices > 1 and partition != "slab":
        return "celllist"
    return "pallas" if dev.type == "cuda" else "celllist"


def _check_partition(args, backend: str) -> None:
    """The backends each multi-rank partition runs (the JAX CLI's refusals,
    ``cli.py:139-150``): the slab engine's sweeps are celllist or pallas,
    the halo-sharded step's celllist only."""
    if args.partition == "slab":
        if backend not in ("celllist", "pallas"):
            raise SystemExit(
                f"--devices {args.devices} --partition slab supports "
                f"--backend celllist or pallas, not {backend}")
    elif backend != "celllist":
        raise SystemExit(
            f"--devices {args.devices} --partition halo uses the sharded "
            f"cell-list step; --backend {backend} is not available")


def _rank_pool(args, cfg, state, backend: str, dev: torch.device):
    """Start the ranks of a ``run --devices N``: their layout
    (``parallel.make_mesh``) and a ``RankPool`` of the partition's worker,
    holding the distributed state from here on.  The slab partition
    derives its split, capped sub-frame bound and caps from ``state`` here,
    as the JAX CLI does."""
    from .parallel import RankPool, make_mesh, slabs
    from .parallel.sharding import HaloRanks
    from .state import state_to_numpy

    layout = make_mesh(args.devices, dev)
    if args.partition == "halo":
        worker, wargs = HaloRanks, (cfg.to_json(), state_to_numpy(state))
    else:
        sweeps = "pallas" if backend == "pallas" else "celllist"
        zsplit = slabs.derive_zsplit(cfg, state, layout.world)
        sub_len = None
        if sweeps == "pallas" and cfg.capped_candidates:
            sub_len = slabs.derive_sub_len_slab(cfg, state, layout.world,
                                                zsplit)
            print(f"derived slab sub_len={sub_len}")
        caps = slabs.derive_slab_caps(cfg, state, layout.world,
                                      zsplit=zsplit)
        worker = slabs.SlabRanks
        wargs = (cfg.to_json(), state_to_numpy(state), zsplit, caps, sweeps,
                 sub_len)
    pool = RankPool(layout.world, worker, *wargs, backend=layout.backend,
                    devices=list(layout.devices), threads=layout.threads)
    return pool, layout


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
    from .state import StepDiagnostics, state_from_numpy
    from .utils import benchmark
    from .utils import io as ckpt_io
    from .utils.diagnostics import (DiagnosticsWriter, detect_blowup,
                                    detect_truncation)

    dev = _device(args.device)
    multi = args.devices > 1
    backend = _backend(args.backend, dev, args.compat, args.devices,
                       args.partition)
    if multi:
        _check_partition(args, backend)
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
        scene_kw = overrides
        if args.exact_ic:
            if args.scene != "disk":
                raise SystemExit("--exact-ic only applies to the disk scene")
            scene_kw = dict(overrides, exact_ic=True)
        cfg, state = benchmark.resolve_scene(args.scene, dev, scene_kw,
                                             args.seed, backend)
    for name in ("pallas_window_t", "capped_sub_len", "range_slice"):
        if getattr(given, name) == 0 and getattr(cfg, name):
            print(f"derived {name}={getattr(cfg, name)}")
    # the multi-rank engines keep their own state; the lazy driver is the
    # single-device loop's
    lazy = not multi and (benchmark.uses_lazy(cfg, backend)
                          if args.lazy is None else args.lazy)
    if lazy and backend != "pallas":
        # the lazy driver always runs the sublane sweeps
        raise SystemExit(f"--lazy drives the pallas sweeps; got --backend "
                         f"{backend}")
    total = cfg.num_steps + 1 if args.steps is None else args.steps

    # the lazy driver's carry between blocks (None: the next block bins
    # ``state`` afresh), or the ranks of ``--devices N``, which hold the
    # state from their start; ``state`` is brought up to date from either
    # only where it is read: a checkpoint, an apply, a frame, the end
    carry = pool = None
    stale = False

    def advance(n):
        nonlocal state, carry, stale
        if pool is not None:
            stale = True
            # the pool's limit for each step: a hang inside the block is
            # caught sooner by the ranks' own collective timeout
            return StepDiagnostics(**pool.call(
                "step", n, limit_s=n * pool.timeout_s)[0])
        if not lazy:
            state, diags = drive_loop(cfg, state, n, backend=backend)
            return diags
        carry, diags = drive_loop_lazy(cfg, state if carry is None else None,
                                       n, carry=carry, keep_carry=True,
                                       scan_block=args.scan_block)
        return diags

    def current():
        """The state in the caller's particle order."""
        nonlocal state, stale
        if stale:
            state = state_from_numpy(pool.call("collect")[0], dev)
            stale = False
        elif carry is not None:
            state = unsort_carry(carry)
        return state

    def shown():
        """The state to draw: a frame is a sum over particles, so the lazy
        carry's sorted frame draws the same image without an unsort."""
        return current() if carry is None else carry.state

    def rebuild(new_cfg):
        """An applied config: the next block rebins from the current state
        under it (the JAX CLI's fresh ``make_run``)."""
        nonlocal cfg, carry
        new_cfg.validate()
        if pool is not None:
            pool.call("rebuild", new_cfg.to_json())
        else:
            current()
        cfg, carry = new_cfg, None

    pending = _applies(args.apply)
    frames = []
    try:
        meta = {}
        if multi:
            # the ranks live until the finally below, whatever ends the run
            pool, layout = _rank_pool(args, cfg, state, backend, dev)
            meta = {"partition": args.partition,
                    "devices": list(layout.devices), "comm": layout.backend}
            where = layout.describe()
        else:
            where = f"devices=[{dev}]"
        with _Signals() as signals:
            print(f"scene={args.scene} n={cfg.num_particles} steps={total} "
                  f"backend={backend} {where}", flush=True)
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
                    "device": benchmark._device_name(dev), **meta})
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
                    if (multi and args.partition == "slab"
                            and args.rebalance_threshold and done < total):
                        moved = pool.call("rebalance",
                                          args.rebalance_threshold)[0]
                        if moved is not None:
                            print(f"rebalanced slabs: p_cap={moved[0]} "
                                  f"zsplit={moved[1]}")
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
                    _draw(args, cfg, shown, done, nblock, total, frames)
                    if not args.quiet:
                        pps = cfg.num_particles * nblock / max(
                            time.perf_counter() - t0, 1e-9)
                        print(f"step {done}/{total}  {dt_ms:.2f} ms/step  "
                              f"{pps:.3e} particle-steps/s")
                elapsed = time.perf_counter() - t_start
            ckpt_io.save_state(os.path.join(args.out, "final_state.npz"),
                               current())
            if frames:
                from .utils.render import save_gif

                save_gif(frames, f"{args.out}/sph_anim.gif")
                print(f"wrote {args.out}/sph_anim.gif ({len(frames)} frames)")
            print(f"done: {total - start_step} steps in {elapsed:.1f}s; "
                  f"diagnostics in {args.out}/")
    finally:
        if pool is not None:
            pool.close()
    return 0


def _draw(args, cfg, shown, done: int, nblock: int, total: int,
          frames: list) -> None:
    """``run``'s pictures at a block boundary: a GIF frame every
    ``--render-every`` steps, the terminal repaint (``--live-term``) and
    the PNG swapped into ``--live``; ``shown()`` gives the state to draw,
    read only when a picture is due."""
    from .utils.render import ansi_frame, render_frame, save_png

    if not (args.live_term or args.live
            or (args.render and (done % args.render_every) < nblock)):
        return
    state = shown()
    if args.render and (done % args.render_every) < nblock:
        frames.append(render_frame(cfg, state))
    if args.live_term:
        import shutil

        tcols, tlines = shutil.get_terminal_size((80, 26))
        frame = ansi_frame(render_frame(cfg, state, size=256),
                           cols=min(tcols, 160),
                           rows=max(min(tlines - 2, 60), 4))
        sys.stdout.write("\x1b[2J\x1b[H" + frame
                         + f"\nstep {done}/{total}\n")
        sys.stdout.flush()
    if args.live:
        tmp = args.live + ".tmp.png"  # the suffix keeps the encoder happy
        save_png(render_frame(cfg, state), tmp)
        os.replace(tmp, args.live)


def cmd_bench(args) -> int:
    from .config import SphConfig
    from .utils.benchmark import run_benchmark, run_slab_benchmark, uses_lazy

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
    ov = _overrides(args)
    backend = _backend(args.backend, dev, args.compat)
    # the JAX CLI's rule (cli.py:452-470): --lazy/--no-lazy (--eager is
    # --no-lazy) forces the driver; by default the lazy loop where it is
    # valid, judged on the default config with the overrides; --lazy with
    # a backend that has no lazy driver is run_benchmark's ValueError
    lazy = args.lazy
    if lazy is None:
        lazy = uses_lazy(SphConfig().replace(**ov), backend)
    r = run_benchmark(scene=args.scene, lazy=lazy, steps=args.steps or 100,
                      warmup=args.warmup, overrides=ov, device=str(dev),
                      seed=args.seed, backend=backend)
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
    backend = _backend(args.backend, dev, args.compat)
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


def cmd_render(args) -> int:
    """A saved state as a PNG (the JAX CLI's ``render``), drawn on the
    device under the scene's config."""
    from .init import load_state
    from .models import scene_config
    from .utils.render import (render_frame, render_frame_perspective,
                               save_png)

    dev = _device(args.device)
    cfg = scene_config(args.scene, **_overrides(args))
    state = load_state(args.state, dev)
    if args.perspective or args.camera:
        cam = {}
        if args.camera:
            try:
                az, el, dist = (float(v) for v in args.camera.split(","))
            except ValueError:
                raise SystemExit("--camera expects AZ,EL,DIST "
                                 "(e.g. --camera 135,0.6,1.8)")
            cam = dict(azimuth=az, elevation=el, distance=dist)
        img = render_frame_perspective(cfg, state, box=not args.no_box, **cam)
    else:
        img = render_frame(cfg, state, voxels=args.voxels)
    save_png(img, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_parity(args) -> int:
    """Step the compat pipeline from a golden dump and report each later
    dump's errors (the JAX CLI's ``parity``)."""
    import glob

    import numpy as np

    from .compat import golden
    from .compat.step import compat_step
    from .config import SphConfig
    from .state import ParticleState

    dev = _device(args.device)
    files = sorted(glob.glob(f"{args.golden}/state_*.bin"))
    if len(files) < 2:
        raise SystemExit(
            f"need >= 2 golden dumps under {args.golden} "
            "(generate with tools/build_reference.sh + golden_gen)")
    g0 = golden.load_golden(files[0])
    cfg = SphConfig(num_particles=g0.n, cell_capacity=args.cell_capacity)
    state = ParticleState.from_arrays(
        torch.from_numpy(g0.position).to(dev),
        torch.from_numpy(g0.velocity).to(dev),
        mass=torch.from_numpy(g0.mass).to(dev))

    worst = 0.0
    for path in files[1:args.steps + 1 if args.steps else None]:
        state, _ = compat_step(cfg, state)
        g = golden.load_golden(path)
        rho = state.density.cpu().numpy()
        l2 = float(np.linalg.norm(rho - g.density)
                   / max(np.linalg.norm(g.density), 1e-30))
        nc_ok = (state.neighbor_count.cpu().numpy()
                 == g.neighbor_count).mean()
        pos_l2 = float(np.linalg.norm(state.position.cpu().numpy()
                                      - g.position)
                       / np.linalg.norm(g.position))
        worst = max(worst, l2)
        print(f"{path}: density_L2={l2:.3e} pos_L2={pos_l2:.3e} "
              f"neighbor_count_match={nc_ok:.4f}")
    target = 1e-3
    print(f"worst density L2 = {worst:.3e}  (north-star target <= "
          f"{target:g}): {'PASS' if worst <= target else 'FAIL'}")
    return 0 if worst <= target else 1


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
                   choices=["auto", "pallas", "celllist", "pairwise",
                            "compat"],
                   help="auto = compat with --compat, else pallas on cuda "
                        "and celllist on cpu")
    p.add_argument("--compat", action="store_true",
                   help="reproduce the C++ reference's quirks")
    p.add_argument("--set", action="append", metavar="KEY=VALUE")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "bench", "sweep", "info", "render"):
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
    p.add_argument("--devices", type=int, default=0,
                   help="run on N ranks (0 or 1 = one device): NCCL ranks "
                        "on N cards, or gloo ranks sharing fewer cards or "
                        "on the CPU")
    p.add_argument("--partition", default="slab", choices=["slab", "halo"],
                   help="multi-rank decomposition: 'slab' = the "
                        "distributed slab engine (parallel/slabs.py); "
                        "'halo' = the row-sharded step whose binning runs "
                        "replicated on every rank (parallel/sharding.py), "
                        "an oracle for the slab engine")
    p.add_argument("--rebalance-threshold", type=float, default=1.5,
                   help="slab partition: re-derive the z-split at block "
                        "boundaries when the per-rank load imbalance "
                        "(max/mean count) exceeds this ratio; 0 disables")
    p.add_argument("--profile-phases", action="store_true",
                   help="time the step's phases once (timing.txt columns)")
    p.add_argument("--render", action="store_true",
                   help="collect GIF frames (<out>/sph_anim.gif)")
    p.add_argument("--render-every", type=int, default=10)
    p.add_argument("--live", default="",
                   help="swap a PNG of the current state into this path "
                        "every block")
    p.add_argument("--live-term", action="store_true",
                   help="repaint the splat in the terminal every block")
    p.add_argument("--exact-ic", action="store_true",
                   help="disk scene: start from the reference's srand(42) "
                        "state bit for bit")
    p.add_argument("--quiet", action="store_true")
    p = sub.choices["bench"]
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--lazy", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="lazy rebinning driver (default: auto, on for the "
                        "sublane pallas backend in default mode)")
    p.add_argument("--eager", dest="lazy", action="store_false",
                   default=None,
                   help="the same as --no-lazy: rebin every step (ops.step)")
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
    p = sub.choices["render"]
    p.add_argument("state", help="path to a .npz state or checkpoint")
    p.add_argument("-o", "--output", default="frame.png")
    p.add_argument("--perspective", action="store_true",
                   help="3-D perspective camera instead of the "
                        "orthographic projection")
    p.add_argument("--camera", default="", metavar="AZ,EL,DIST",
                   help="perspective view: azimuth degrees around +y (180 "
                        "= the -z view), elevation (fraction of the box "
                        "span), eye distance (box spans); implies "
                        "--perspective")
    p.add_argument("--no-box", action="store_true",
                   help="perspective view: no wireframe box outline")
    p.add_argument("--voxels", action="store_true",
                   help="overlay occupied grid cells in red")
    p = sub.add_parser("parity")
    p.add_argument("golden", help="directory of golden state dumps "
                                  "(state_*.bin)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cell-capacity", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p = sub.add_parser("watch")
    p.add_argument("--out", default="out", help="run output directory")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit")
    args = ap.parse_args(argv)
    return {"run": cmd_run, "bench": cmd_bench, "sweep": cmd_sweep,
            "info": cmd_info, "watch": cmd_watch, "render": cmd_render,
            "parity": cmd_parity}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
