"""The capped mode's full-run acceptance record on the card: counterpart of
``tools/capped_fullrun.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.capped_fullrun \\
        [--rows disk_32k,splash_1m] [--steps-scale 1.0] [--out F.json] \\
        [-n N] [--device cpu]

Runs the reference's workload and the splash at their full durations,
exact and capped K_c = 4 (mass-reweighted), through the lazy driver
(``ops.lazy.drive_loop_lazy``):

  * ``disk_32k``: the 32k disk, 1,001 steps, 2h cells (the reference's own
    workload; |L| is its key invariant);
  * ``splash_1m``: the 1M splash, 1,000 steps, 1.25h cells.

Per run it records the wall time and ms/step (host clock, ended by a device
sync; the kernels are built before the first run), the energy drift, the
|L| drift, the kinetic-energy tail mean and the last neighbor mean; per row
the KE tail ratio capped / exact, whether the cap binds (capped neighbor
mean under 0.85x exact at the end) and the capped over exact mean density
on one state, at the start and at the exact run's end state
(``ops.sweeps_t.compute_step_quantities``).  The record is written after
each row (default ``docs/capped_fullrun_torch.json``; the JAX package's
``docs/capped_fullrun.json`` is its TPU record) with the card's name and
power limit in ``device``; ``tests/test_torch_tools_fullrun.py`` holds the
committed record to the JAX record's envelopes.

``scan_block`` (50 and 25, the JAX tool's) is recorded; the port's lazy
driver runs the steps one by one either way.  ``-n N`` sets every row's
particle count, and a run with ``-n`` or ``--steps-scale`` below 1 is
marked ``"smoke": true`` (the tests run it at a few thousand particles on
the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..models import make_scene
from ..ops import sweeps_t
from ..ops.lazy import drive_loop_lazy
from ..utils import build
from . import card_line, host_tag, start, sync

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "docs", "capped_fullrun_torch.json")


def _tail_mean(x, frac: float = 0.2) -> float:
    arr = np.asarray(x, dtype=np.float64)
    return float(arr[-max(int(len(arr) * frac), 1):].mean())


def _drift(ke, pe) -> float:
    tot = np.asarray(ke, np.float64) + np.asarray(pe, np.float64)
    return abs(float(tot[-1]) - float(tot[0])) / max(abs(float(tot[0])), 1e-30)


def _same_state_density_ratio(cfg, state) -> float:
    """Capped K_c = 4 over exact mean density on one state."""
    _, rho_c, _ = sweeps_t.compute_step_quantities(
        cfg.replace(capped_candidates=4), state)
    _, rho_e, _ = sweeps_t.compute_step_quantities(
        cfg.replace(capped_candidates=0), state)
    return float(rho_c.double().mean() / rho_e.double().mean())


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().double().numpy()


def run_pair(scene: str, steps: int, scan_block: int, device="cuda",
             **kw) -> dict:
    """One exact + one capped-K4 run of ``steps`` steps through the lazy
    driver from the same scene (``kw`` overrides its config)."""
    dev = torch.device(device)
    cfg, state0 = make_scene(scene, device=dev, **kw)
    out = {"scene": scene, "steps": steps,
           "num_particles": kw.get("num_particles"),
           "overrides": {k: v for k, v in kw.items() if k != "num_particles"},
           "scan_block": scan_block}
    runs = {}
    for name, cfg_r in (("exact", cfg),
                        ("capped_k4", cfg.replace(capped_candidates=4))):
        sync(dev)
        t0 = time.perf_counter()
        s_end, d = drive_loop_lazy(cfg_r, state0, steps,
                                   scan_block=scan_block)
        sync(dev)
        wall = time.perf_counter() - t0
        ke, pe = _numpy(d.kinetic_energy), _numpy(d.potential_energy)
        ll, nm = _numpy(d.angular_momentum), _numpy(d.neighbor_mean)
        runs[name] = {
            "wall_s": wall, "ms_per_step": wall * 1e3 / steps,
            "finite": bool(np.isfinite(ke).all() and np.isfinite(ll).all()),
            "energy_drift": _drift(ke, pe),
            "ke_tail_mean": _tail_mean(ke),
            "l_drift": (abs(float(ll[-1]) - float(ll[0]))
                        / max(abs(float(ll[0])), 1e-30)),
            "neighbor_mean_last": float(nm[-1]),
            "truncated_ranges_max": int(d.truncated_ranges.max()),
            "state_end": s_end,
        }
        print(f"  {scene} {name}: {wall:.1f}s "
              f"({runs[name]['ms_per_step']:.3f} ms/step"
              f"{host_tag(dev)}) "
              f"drift {runs[name]['energy_drift']:.4f} "
              f"|L| drift {runs[name]['l_drift']:.5f}", flush=True)
    e, c = runs["exact"], runs["capped_k4"]
    out["exact"] = {k: v for k, v in e.items() if k != "state_end"}
    out["capped_k4"] = {k: v for k, v in c.items() if k != "state_end"}
    out["ke_tail_ratio"] = c["ke_tail_mean"] / max(e["ke_tail_mean"], 1e-30)
    out["cap_binds"] = c["neighbor_mean_last"] < 0.85 * e["neighbor_mean_last"]
    # same-state unbiasedness at the initial and the evolved exact state:
    # sampling bias apart from the trajectories' chaos
    out["density_ratio_t0"] = _same_state_density_ratio(cfg, state0)
    out["density_ratio_end"] = _same_state_density_ratio(cfg, e["state_end"])
    return out


# the JAX tool's rows (its ROWS): steps at scale 1, scan_block, overrides
ROWS = {
    # the reference workload: 32k disk, 1001 steps, 2h cells
    "disk_32k": (1001, 50, dict(num_particles=32768, cell_size_factor=2.0)),
    # the splash workload: 1M, 1000 steps, the production cell size
    "splash_1m": (1000, 25, dict(num_particles=1_000_000,
                                 cell_size_factor=1.25)),
}
SCENES = {"disk_32k": "disk", "splash_1m": "splash"}

# the JAX record's envelopes (tests/test_capped.py, the full-run record's
# test): KE tail ratio bounds and the capped run's energy drift bound (None:
# within 1.5x exact + 0.10, since the splash's total energy starts near 0)
ENVELOPES = {"disk_32k": {"ke": (0.70, 1.45), "drift_abs": 0.75},
             "splash_1m": {"ke": (0.85, 1.20), "drift_abs": None}}


def envelope_failures(rows: dict) -> list[str]:
    """The envelopes a record's rows miss (empty when all hold): both runs
    finite, both density ratios in (0.97, 1.03), the cap binding, the KE
    tail ratio and the capped energy drift within the row's bounds."""
    bad = []
    for name, row in rows.items():
        env = ENVELOPES[name]
        c = row["capped_k4"]
        checks = {
            "finite": row["exact"]["finite"] and c["finite"],
            "density_ratio_t0": 0.97 < row["density_ratio_t0"] < 1.03,
            "density_ratio_end": 0.97 < row["density_ratio_end"] < 1.03,
            "cap_binds": row["cap_binds"],
            "ke_tail_ratio": (env["ke"][0] < row["ke_tail_ratio"]
                              < env["ke"][1]),
            "energy_drift": (
                c["energy_drift"] < env["drift_abs"]
                if env["drift_abs"] is not None else
                c["energy_drift"] < 1.5 * row["exact"]["energy_drift"] + 0.10),
        }
        bad += [f"{name}: {k}" for k, ok in checks.items() if not ok]
    return bad


def run_row(row: str, scale: float, device="cuda", n: int | None = None
            ) -> dict:
    steps, scan_block, kw = ROWS[row]
    kw = dict(kw, **({} if n is None else {"num_particles": n}))
    return run_pair(SCENES[row], max(int(steps * scale), 2), scan_block,
                    device=device, **kw)


def main(rows: str = "disk_32k,splash_1m", steps_scale: float = 1.0,
         out: str = DEFAULT_OUT, n: int | None = None,
         device="cuda") -> dict:
    dev = start(device)
    if dev.type == "cuda":
        build.build_libraries(["sweep_t"])   # the build stays off the clock
    results = {"device": card_line(dev), "package":
               "smoothed_particle_hydrodynamics_tpu_torch",
               "torch": torch.__version__,
               "steps_scale": steps_scale,
               "smoke": n is not None or steps_scale < 1.0, "rows": {}}
    if n is not None:
        results["num_particles"] = n
    for row in rows.split(","):
        print(f"running {row} ...", flush=True)
        results["rows"][row] = run_row(row, steps_scale, dev, n)
        with open(out, "w") as f:   # write as each row completes
            json.dump(results, f, indent=1)
    print(f"wrote {out}")
    return results


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "capped_fullrun")
    ap.add_argument("--rows", default="disk_32k,splash_1m")
    ap.add_argument("--steps-scale", type=float, default=1.0,
                    help="scale the step counts (smoke runs)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("-n", "--num-particles", type=int, default=None,
                    help="every row's particle count (smoke runs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(args.rows, args.steps_scale, args.out, args.num_particles,
         args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
