#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (every failed check raises, and the script exits nonzero):

1. build the sweep kernels (``csrc/sweep_t.cu``) with nvcc; print the build
   time and ptxas's register/spill report;
2. 32k splash: each kernel against its plain PyTorch twin on the card
   (neighbor counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4);
3. 4096-particle splash: the kernel-backed step quantities against the
   O(N^2) pairwise oracle, with the same bars;
4. 1M splash shapes: kernel and twin times (CUDA events) and their
   agreement at the main path's shapes;
5. the main path: ``run_benchmark`` drives the 1M lazy splash (3 warmup +
   20 timed steps) with the launch counters reset just before; each kernel
   must have launched once per step, and the final state must be finite.

It then prints the card's name and power limit, one JSON line of kernel
records, and last ``{"ok": true, "device": {...}}``.  With no CUDA device it
exits 1 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# the main path: bench.py's headline row (1M splash, lazy rebinning, 1.25h cells)
MAIN = dict(num_particles=1_000_000, cell_size_factor=1.25, pallas_window_t=208)
WARMUP, STEPS = 3, 20
RHO_BAR, ACC_BAR = 1e-6, 1e-4
SOURCE = "smoothed_particle_hydrodynamics_tpu_torch/csrc/sweep_t.cu"
REPLACES = {"density_kernel_t": "smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py:293",
            "force_kernel_t": "smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py:360"}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).abs().max().item()


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs after one warm run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernels_vs_twins(cfg, p, label: str) -> dict:
    """Run both kernels and both twins on the same card tensors; check the
    bars and return the max abs errors."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    rho_k, nc_k = sw.density_t(cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)
    rho_p, nc_p = sw.density_t_plain(cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_k, p.mass_s)
    acc_k = sw.force_t(cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.ws, p.wc)
    acc_p = sw.force_t_plain(cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid,
                             p.ws, p.wc)
    torch.cuda.synchronize()
    counts_equal = bool((nc_k == nc_p).all())
    r_rho, r_acc = rel_l2(rho_k, rho_p), rel_l2(acc_k, acc_p)
    print(f"[{label}] kernel vs twin: counts_equal={counts_equal} "
          f"mean_neighbors={nc_k.float().mean().item():.3f} "
          f"rho_rel_l2={r_rho:.3e} acc_rel_l2={r_acc:.3e} "
          f"max_wc={p.wc.max().item()}")
    check(counts_equal, f"{label}: neighbor counts kernel == twin")
    check(r_rho <= RHO_BAR, f"{label}: rho rel-L2 {r_rho} <= {RHO_BAR}")
    check(r_acc <= ACC_BAR, f"{label}: acc rel-L2 {r_acc} <= {ACC_BAR}")
    return {"density_kernel_t": max_abs(rho_k, rho_p),
            "force_kernel_t": max_abs(acc_k, acc_p)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils import build
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        run_benchmark)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build from the checkout's sources
    t0 = time.perf_counter()
    build.load_library("sweep_t")
    print(f"[build] sweep_t.cu built+loaded in {time.perf_counter() - t0:.2f} s")
    print(build.build_log("sweep_t").strip())

    # 2. kernels vs twins, 32k splash (packed pool: 32^3 grid of 1.25h cells;
    #    64-row windows so multi-chunk walks are exercised)
    cfg, st = make_scene("splash", device=dev, num_particles=32768,
                         cell_size_factor=1.25, pallas_window_t=64,
                         grid_nx=32, grid_ny=32, grid_nz=32)
    kernels_vs_twins(cfg, sw.prepare_t(cfg, st), "32k")

    # 3. kernels vs the pairwise oracle, n = 4096 (hydro only: no gravity)
    cfg, st = make_scene("splash", device=dev, num_particles=4096,
                         cell_size_factor=1.25, pallas_window_t=64,
                         grid_nx=16, grid_ny=16, grid_nz=16,
                         gravity=(0.0, 0.0, 0.0))
    acc, rho, nc = sw.compute_step_quantities(cfg, st)
    rho_o = pairwise.compute_density(cfg, st)
    nc_o = pairwise.neighbor_counts(cfg, st)
    acc_o = pairwise.compute_acceleration(cfg, st, rho_o)
    r_rho, r_acc = rel_l2(rho, rho_o), rel_l2(acc, acc_o)
    print(f"[4096] kernels vs pairwise: counts_equal={bool((nc == nc_o).all())}"
          f" rho_rel_l2={r_rho:.3e} acc_rel_l2={r_acc:.3e}")
    check(bool((nc == nc_o).all()), "4096: counts kernel == pairwise")
    check(r_rho <= RHO_BAR, f"4096: rho rel-L2 {r_rho} <= {RHO_BAR}")
    check(r_acc <= ACC_BAR, f"4096: acc rel-L2 {r_acc} <= {ACC_BAR}")

    # 4. the main path's shapes: agreement and times, kernel vs twin
    cfg, st = make_scene("splash", device=dev, **MAIN)
    p = sw.prepare_t(cfg, st)
    errs = kernels_vs_twins(cfg, p, "1M")
    rho = sw.density_t(cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)[0]
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho, p.mass_s)
    args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)
    args_f = (cfg, p.pos_s, p.vel_s, rho, cand, p.cid, p.ws, p.wc)
    times = {
        "density_kernel_t": (time_ms(lambda: sw.density_t(*args_d), 10),
                             time_ms(lambda: sw.density_t_plain(*args_d), 3)),
        "force_kernel_t": (time_ms(lambda: sw.force_t(*args_f), 10),
                           time_ms(lambda: sw.force_t_plain(*args_f), 3)),
    }
    for name, (k_ms, p_ms) in times.items():
        print(f"[1M] {name}: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms")
    del p, st, rho, cand, args_d, args_f

    # 5. the main path, counted
    sw.density_t.launches = 0
    sw.force_t.launches = 0
    r = run_benchmark(scene="splash", lazy=True, steps=STEPS, warmup=WARMUP,
                      overrides=MAIN, device="cuda")
    launches = {"density_kernel_t": sw.density_t.launches,
                "force_kernel_t": sw.force_t.launches}
    total_steps = r["warmup_steps"] + r["steps"]
    print(f"[main] 1M splash lazy: {r['ms_per_step']:.4f} ms/step, "
          f"{r['value']:.6e} particle-steps/s over {r['steps']} steps "
          f"(warmup {r['warmup_steps']} steps, {r['warmup_s']:.2f} s); "
          f"rebins in timed steps {r['rebins']}; launches {launches} "
          f"for {total_steps} steps; KE {r['kinetic_energy'][0]:.6e} -> "
          f"{r['kinetic_energy'][-1]:.6e}; finite={r['finite']}")
    for name, count in launches.items():
        check(count == total_steps, f"{name} launched {count} times in "
              f"{total_steps} steps")
    check(r["finite"], "1M lazy run: positions, velocities and KE finite")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("density_kernel_t", "force_kernel_t")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
