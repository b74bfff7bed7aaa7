"""One run of one benchmark cell of the port, on the card it starts on.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up: the cell's initial conditions drawn from ``--seed`` on the card,
the settings resolved as ``run`` resolves them, and one block of the
cell's own shapes run as a warm-up (the first run in a checkout also
builds the port's CUDA libraries into its ``_build/``).  Then the timed
window of whole solves (``window.py``), then, with ``--trace 1``, a solve
timed a step at a time and a solve under ``torch.profiler``.  Once the
window has closed, the reference checks the steps drawn from the seed
(``reference.py``, ``compare.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (steps in the window), ``failed`` (steps that lost a
candidate, overflowed a cell or ended non-finite), ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared with its limit, also printed last on standard error.
Without a CUDA card, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import compare  # noqa: E402
import core  # noqa: E402
import devtrace  # noqa: E402
import port  # noqa: E402
import reference  # noqa: E402
import scene  # noqa: E402
import spec  # noqa: E402
import window  # noqa: E402
import work  # noqa: E402

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "smoothed_particle_hydrodynamics_tpu")


def forbidden_loaded() -> list[str]:
    """Top-level names in ``sys.modules`` that are in ``FORBIDDEN``,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _unsort(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    out = x.new_empty(x.shape)
    out[order] = x
    return out


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


def copies_bytes(sink: list) -> int:
    """Bytes that the checked steps' copies hold on the device."""
    return sum(t.numel() * t.element_size() for s in sink
               for part in (s["before"], s["after"]) for t in part.values())


def check_steps(config: dict, sink: list, mass: torch.Tensor,
                control: bool = False) -> tuple[list[dict], list[dict]]:
    """The reference's reading of each checked step, consuming ``sink``:
    the step's outputs against the reference from the state it started
    from, all in the original particle order; with ``control``, also the
    reference in bfloat16 put in the program's place.  In capped mode both
    are handed the bins the step used: at a solve's first step its initial
    state in the original order, else the step's copies of them."""
    c = spec.constants(config["sph"])
    readings, controls = [], []
    while sink:
        s = sink.pop(0)
        pre, post = s["before"], s["after"]
        x0 = _unsort(pre["pos"], pre["order"])
        v0 = _unsort(pre["vel"], pre["order"])
        bins = None
        if "bin_pos" in post:
            ids = torch.arange(x0.shape[0], device=x0.device)
            bins = ({"pos": x0, "row": ids} if s["step"] == 0 else
                    {"pos": _unsort(post["bin_pos"], post["order"]),
                     "row": _unsort(ids, post["bin_from"])})
        ref = reference.step(c, x0, v0, mass, bins=bins)
        out = {k: _unsort(post[k], post["order"])
               for k in ("count", "rho", "acc", "pos", "vel")}
        readings.append(compare.step_numbers(out, ref, c["h"]))
        if control:
            low = reference.step(c, x0, v0, mass, dtype=torch.bfloat16,
                                 bins=bins)
            controls.append(compare.step_numbers(low, ref, c["h"]))
    return readings, controls


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             dev, t_start: float, root: Path | None = None,
             here: Path = HERE) -> dict:
    """One run of cell ``name`` on ``dev``; returns the result's fields
    and, under ``info``, what is printed before it."""
    cell = core.cell(bench, name, root or here.parent, here)
    config, traffic = cell["config"], cell["traffic"]
    steps = spec.constants(config["sph"])["steps"]
    block = traffic["block"]
    phases = {"imports": time.perf_counter() - t_start}
    pos, vel, mass = scene.draw(config, seed, dev)
    cfg, init = port.make_config(config["sph"], pos, vel, mass)
    del pos, vel
    window.sync(dev)
    phases["initial_state"] = time.perf_counter() - t_start
    window.solve(cfg, init, block, block, dev)  # the warm-up block
    checks = window.draw_checks(seed, traffic["checked_steps"],
                                traffic["checked_solves"], steps, block)
    window.sync(dev)
    setup_s = time.perf_counter() - t_start
    phases["warm_block"] = setup_s
    sink: list = []
    win = window.timed_window(cfg, init, steps, block, seconds, dev, checks,
                              sink)
    record = {"particles": init.position.shape[0], "setup_s": setup_s, **win}
    breakdown = None
    if trace:
        record["untraced_ms_per_step"] = win["window_s"] * 1e3 / win["steps"]
        record.update(window.per_step(cfg, init, steps, dev))
        solved: list = []
        cap = devtrace.capture(lambda: solved.append(
            window.solve(cfg, init, steps, block, dev)), dev)
        prof = devtrace.reduce(cap["device"], cap["host"])
        nbr = sum(solved[0]["neighbor_mean"]) / steps
        record["profile"] = dict(prof, steps=steps, wall_s=cap["wall_s"],
                                 neighbor_mean=nbr)
        record["layers"] = core.layer_patterns(here)
        record["bound"] = work.sweeps_bound(record["particles"], nbr)
        breakdown = {"device_ops": devtrace.top(prof["device_s"]),
                     "idle_gaps": devtrace.top(prof["gaps_s"])}
    cuda = dev.type == "cuda"
    # the program's own peak: the checked steps' copies, all made in the
    # first solves, are left out; every later solve bins and rebins again
    peak_all = torch.cuda.max_memory_allocated(dev) if cuda else 0
    copies = copies_bytes(sink)
    peak = peak_all - copies if cuda else 0
    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = core.read_metrics(entries, record, here)
    info = {"cell": name, "seed": seed, "solves": win["solves"],
            "steps": win["steps"], "window_s": win["window_s"],
            "rebins": win["rebins"], "solve_s": win["solve_s"],
            "setup_phases_s": phases, "block": block, "steps_per_solve": steps,
            "window_t": cfg.pallas_window_t, "block_t": cfg.pallas_block_t,
            "capped_sub_len": cfg.capped_sub_len, "memory_peak_bytes": peak,
            "memory_peak_with_copies_bytes": peak_all,
            "checked_copies_bytes": copies,
            "checked": sorted(f"{s['solve']}:{s['step']}" for s in sink)}
    if trace:
        info["bound"] = record["bound"]
        unclaimed = core.layer_ops(record, None)
        info["unclaimed_device_ms_per_step"] = (
            sum(unclaimed.values()) * 1e3 / steps)
        info["unclaimed_ops"] = devtrace.top(unclaimed)
    # the program's state is freed before the reference runs
    del cfg, init, record
    if cuda:
        torch.cuda.empty_cache()
    readings, _ = check_steps(config, sink, mass)
    correct, table = compare.judge(compare.worst(readings), cell["limits"])
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": cell["workload"]["chips"],
              "memory_peak_bytes": peak}
    if trace:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = cap["wall_s"]
    result = {"correct": correct, "attempted": win["steps"],
              "failed": win["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return {"result": result, "info": info}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = core.load_bench()
    chips = next(w["chips"] for w in bench["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one loading process, few threads
    dev = torch.device("cuda", 0)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), dev, T_START)
    print(f"card: {power_limit()}", flush=True)
    bad = forbidden_loaded()
    if bad:
        print(f"bench_port: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out["info"]), flush=True)
    for k, t in out["result"]["checks"].items():
        print(f"check {k} {t['value']!r} limit {t['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
