"""Step times of the port's main paths on two source trees, in turns.

    python -m smoothed_particle_hydrodynamics_tpu_torch.utils.turns \
        --trees PARENT . [--rounds 2] [--repeat 2] [--steps 100] \
        [--paths exact capped ...] [--out turns.json] [-n N] [--device D]

Each round runs one process per tree in the order A B B A (then B A A B in
the next round, so neither tree always goes first).  A process imports the
package from its own tree and drives every path ``--repeat`` times:
``utils.benchmark.run_benchmark`` (1M splash; exact, capped and fused
lazy, lane eager; ``groups2``/``groups4`` the exact path at
``pallas_groups`` 2 and 4) or ``run_slab_benchmark`` (the slab engine at world size
1; exact, capped, fused), 3 warmup + ``--steps`` timed steps, the shapes
of ``chip_smoke.py``'s main paths.  ``run`` is the CLI's ``run --scene
splash`` in blocks of 10, in a fresh working directory, timed over the
blocks after the first from its per-block ms/step (``diagnostics.jsonl``,
or the JSON line per block that ``run`` printed before it wrote its
outputs); ``splash`` is ``run_benchmark`` on the same config.  Each
worker prints one JSON line of ms/step per path; the main process prints
the card's name and power limit and then, per path and tree, the median,
min and max over all runs and the change of the medians (second tree over
first), and for each pair of paths the median ratio of their times in the
same process.  ``--summarize
F.json`` prints that summary again from a saved ``--out`` file.  Each
tree builds its own kernels on first use.  ``-n`` and ``--device cpu``
shrink a run to check the script on the CPU; such a time is never a
device number.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# the shapes of chip_smoke.py's main paths (MAIN, CAPPED, FUSED, LANE; SLAB,
# SLAB_CAPPED, SLAB_FUSED): (engine, lazy, overrides)
_SPLASH = dict(num_particles=1_000_000, cell_size_factor=1.25)
_CAPPED = dict(_SPLASH, capped_candidates=4, pallas_window_t=0)
_SLAB_CAPPED = dict(cell_size_factor=1.25, capped_candidates=4,
                    pallas_block_t=256, pallas_window_t=0)
PATHS = {
    "exact": ("single", True, dict(_SPLASH, pallas_window_t=208)),
    "capped": ("single", True, _CAPPED),
    "fused": ("single", True, dict(_CAPPED, capped_fused=True)),
    "lane": ("single", False, dict(num_particles=1_000_000,
                                   pallas_layout="lane")),
    "slab_exact": ("slab", True, dict(cell_size_factor=1.25)),
    "slab_capped": ("slab", True, _SLAB_CAPPED),
    "slab_fused": ("slab", True, dict(_SLAB_CAPPED, capped_fused=True)),
    "run": ("cli", True, {}),
    "splash": ("single", True, {}),
    # the exact path with lane groups: no sweep reads a window table, so
    # the groups change nothing on this path
    "groups2": ("single", True, dict(_SPLASH, pallas_window_t=208,
                                     pallas_groups=2)),
    "groups4": ("single", True, dict(_SPLASH, pallas_window_t=208,
                                     pallas_groups=4)),
}
WARMUP = 3
CLI_BLOCK = 10


def cli_ms(steps: int, n: int, device: str) -> float:
    """``run --scene splash``'s mean ms/step over ``steps`` steps after a
    first block of ``CLI_BLOCK``, in a temporary working directory."""
    import contextlib
    import io
    import tempfile

    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main as cli

    argv = ["run", "--scene", "splash", "-n", str(n), "--steps",
            str(CLI_BLOCK + steps), "--block", str(CLI_BLOCK), "--device",
            device, "--backend", "pallas"]
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                if cli(argv) != 0:
                    raise RuntimeError("run failed")
            jsonl = os.path.join("out", "diagnostics.jsonl")
            if os.path.exists(jsonl):
                with open(jsonl) as fh:
                    ms = [json.loads(ln)["step_ms"] for ln in fh][CLI_BLOCK:]
            else:
                ms = [json.loads(ln)["ms_per_step"]
                      for ln in text.getvalue().splitlines()
                      if ln.startswith("{")][1:]
        finally:
            os.chdir(here)
    return statistics.fmean(ms)


def worker(paths: list[str], repeat: int, steps: int, n: int = 1_000_000,
           device: str = "cuda") -> dict:
    """Every path ``repeat`` times in this process: ms/step per run."""
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        run_benchmark, run_slab_benchmark)

    out = {}
    for _ in range(repeat):
        for path in paths:
            engine, lazy, ov = PATHS[path]
            if engine == "cli":
                out.setdefault(path, []).append(cli_ms(steps, n, device))
                continue
            if engine == "single":
                r = run_benchmark(scene="splash", lazy=lazy, steps=steps,
                                  warmup=WARMUP, backend="pallas",
                                  overrides=dict(ov, num_particles=n),
                                  device=device)
            else:
                r = run_slab_benchmark(n=n, steps=steps, warmup=WARMUP,
                                       headroom=1.05, overrides=ov,
                                       device=device)
            if not r["finite"]:
                raise RuntimeError(f"{path}: state not finite")
            out.setdefault(path, []).append(r["ms_per_step"])
    return out


def summarize(runs: dict, paths: list[str], a: str, b: str) -> dict:
    """Per path and tree the median, min and max, and the change of the
    medians; for each pair of paths p, q (p listed first) the median over
    runs of p / q, the two timed in the same process."""
    summary = {}
    for p in paths:
        med = {t: statistics.median(runs[t][p]) for t in (a, b)}
        summary[p] = {
            "median": med, "min": {t: min(runs[t][p]) for t in (a, b)},
            "max": {t: max(runs[t][p]) for t in (a, b)},
            "runs": len(runs[a][p]), "change": med[b] / med[a] - 1.0}
        print(f"[turns] {p}: median {med[a]:.3f} ({a}) -> {med[b]:.3f} "
              f"({b}) ms/step, {summary[p]['change'] * 100:+.1f} %, "
              f"{summary[p]['runs']} runs each; range {a} "
              f"{summary[p]['min'][a]:.3f}-{summary[p]['max'][a]:.3f}, {b} "
              f"{summary[p]['min'][b]:.3f}-{summary[p]['max'][b]:.3f}",
              flush=True)
    for i, p in enumerate(paths):
        for q in paths[i + 1:]:
            ratio = {t: statistics.median(x / y for x, y in zip(
                runs[t][p], runs[t][q])) for t in (a, b)}
            summary[f"{p}/{q}"] = {"paired_median": ratio}
            print(f"[turns] {p}/{q} in the same process: median "
                  f"{ratio[a]:.4f} ({a}), {ratio[b]:.4f} ({b})", flush=True)
    return summary


def _run_tree(tree: str, args) -> dict:
    """One worker process importing the package from ``tree``."""
    root = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=root)
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", "--steps",
           str(args.steps), "--repeat", str(args.repeat), "-n", str(args.n),
           "--device", args.device, "--paths", *args.paths]
    done = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=args.timeout)
    if done.returncode != 0:
        raise RuntimeError(f"worker in {tree} failed:\n{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, default=None)
    # the group paths only on request: an older tree has no lane groups
    ap.add_argument("--paths", nargs="+", choices=list(PATHS),
                    default=[p for p in PATHS if not p.startswith("groups")])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("-n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--summarize", default=None, metavar="TURNS_JSON",
                    help="print the summary of a saved --out file")
    args = ap.parse_args(argv)
    if args.summarize:
        with open(args.summarize) as f:
            saved = json.load(f)
        print(saved["device"])
        a, b = dict.fromkeys(saved["order"])
        summarize(saved["runs"], list(saved["runs"][a]), a, b)
        return 0
    if args.worker:
        # import the package from the tree this process runs in, not from
        # the directory of this file
        sys.path[0] = os.getcwd()
        print(json.dumps(worker(args.paths, args.repeat, args.steps, args.n,
                                args.device)))
        return 0
    if args.trees is None:
        ap.error("--trees A B is required")
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    a, b = args.trees
    runs = {t: {p: [] for p in args.paths} for t in (a, b)}
    order = []
    for k in range(args.rounds):
        order += [a, b, b, a] if k % 2 == 0 else [b, a, a, b]
    for tree in order:
        got = _run_tree(tree, args)
        print(json.dumps({"tree": tree, "ms_per_step": got}), flush=True)
        for p, v in got.items():
            runs[tree][p] += v
    summary = summarize(runs, args.paths, a, b)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": card, "order": order,
                       "runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
