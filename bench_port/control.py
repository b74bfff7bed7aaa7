"""The readings the limits of ``compare.py`` are set from, on the card.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3]

For each seed, in one process: the cell's initial conditions, one whole
solve of the program with as many checked steps as a run draws (all in
that solve), and each checked step read twice against the float32
reference from the state it started from: the program's outputs (the
lower readings), and, for the control seeds, the reference computed in
bfloat16, the nearest precision below the configuration's float32, put in
the program's place (the upper readings).  Prints one JSON line a seed,
then the largest program reading and the smallest control reading of each
number.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _p in (str(HERE), str(HERE.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

import compare  # noqa: E402
import core  # noqa: E402
import port  # noqa: E402
import run  # noqa: E402
import scene  # noqa: E402
import spec  # noqa: E402
import window  # noqa: E402


def readings(cell: dict, seed: int, dev: torch.device, control: bool,
             warm: bool) -> dict:
    """One seed's worst program reading and, with ``control``, the worst
    control reading (each over the checked steps)."""
    config, traffic = cell["config"], cell["traffic"]
    steps = spec.constants(config["sph"])["steps"]
    block = traffic["block"]
    pos, vel, mass = scene.draw(config, seed, dev)
    cfg, init = port.make_config(config["sph"], pos, vel, mass)
    if warm:
        window.solve(cfg, init, block, block, dev)
    checks = window.draw_checks(seed, traffic["checked_steps"], 1, steps,
                                block)
    sink: list = []
    t0 = time.perf_counter()
    window.solve(cfg, init, steps, block, dev, checks, 0, sink)
    window.sync(dev)
    solve_s = time.perf_counter() - t0
    checked = [s["step"] for s in sink]
    del cfg, init
    t0 = time.perf_counter()
    prog, ctrl = run.check_steps(config, sink, mass, control)
    rec = {"seed": seed, "checked": checked, "solve_s": solve_s,
           "check_s": time.perf_counter() - t0,
           "program": compare.worst(prog)}
    if control:
        rec["control"] = compare.worst(ctrl)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench_port/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = core.cell(core.load_bench(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    recs = []
    for i, seed in enumerate(seeds):
        recs.append(readings(cell, seed, dev, seed in ctrl_seeds, i == 0))
        print(json.dumps(recs[-1]), flush=True)
    names = list(recs[0]["program"])
    summary = {"lower": {k: max(r["program"][k] for r in recs)
                         for k in names}}
    with_ctrl = [r for r in recs if "control" in r]
    if with_ctrl:
        summary["upper"] = {k: min(r["control"][k] for r in with_ctrl)
                            for k in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
