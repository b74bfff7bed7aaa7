#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (every failed check raises, and the script exits nonzero):

1. build the sweep kernels (``csrc/sweep_t.cu``) with nvcc; print the build
   time and ptxas's register/spill report;
2. exact mode, 32k splash: K1 and K2 against their plain PyTorch twins on
   the card (neighbor counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4);
3. exact mode, 4096-particle splash: the kernel-backed step quantities
   against the O(N^2) pairwise oracle, with the same bars;
4. exact mode, 1M splash shapes: kernel and twin times (CUDA events) and
   their agreement at the main path's shapes;
5. capped mode (K_c = 4), 32k splash: capped K1, capped K2, the pre-pass K1
   and the fused K3 against their twins, and K3's rho and counts against
   capped K1's on the same tensors;
6. capped mode, 4096-particle splash with a keep-all cap (K_c = the largest
   cell occupancy), two-pass and fused, against the pairwise oracle;
7. capped mode, 1M splash shapes: the same kernel-vs-twin checks and times,
   and the capped density mean over the exact one on the same state in
   (0.99, 1.01) (the sampling is unbiased);
8. the main paths, each with the launch counters reset just before:
   ``run_benchmark`` drives the 1M lazy splash (3 warmup + 20 timed steps)
   exact, capped two-pass and capped fused (bench.py's ``capped_k4`` row:
   block 256, window and sub-frame length derived).  Each kernel of a path
   must have launched once per step, no step may drop candidates
   (``truncated_ranges`` 0) and the final state must be finite.

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

# the main paths: bench.py's headline row (1M splash, lazy rebinning, 1.25h
# cells) and its capped_k4 row, two-pass and fused
MAIN = dict(num_particles=1_000_000, cell_size_factor=1.25, pallas_window_t=208)
CAPPED = dict(num_particles=1_000_000, cell_size_factor=1.25,
              capped_candidates=4, pallas_window_t=0)
FUSED = dict(CAPPED, capped_fused=True)
WARMUP, STEPS = 3, 20
RHO_BAR, ACC_BAR = 1e-6, 1e-4
SOURCE = "smoothed_particle_hydrodynamics_tpu_torch/csrc/sweep_t.cu"
TPU = "smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py"
# kernel record name -> (wrapper, its plain twin (both in ops/sweeps_t.py),
# TPU kernel file:line)
KERNELS = {
    "density_kernel_t": ("density_t", "density_t_plain", f"{TPU}:293"),
    "force_kernel_t": ("force_t", "force_t_plain", f"{TPU}:360"),
    "density_kernel_t<capped>": ("density_capped_t", "density_t_plain",
                                 f"{TPU}:321"),
    "force_kernel_t<capped>": ("force_capped_t", "force_t_plain",
                               f"{TPU}:403"),
    "density_kernel_t<prepass>": ("density_pre_t", "density_pre_t_plain",
                                  f"{TPU}:318"),
    "fused_kernel_t": ("fused_t", "fused_t_plain", f"{TPU}:497"),
}
# which kernels each main path runs
PATHS = {
    "exact": (MAIN, ("density_kernel_t", "force_kernel_t")),
    "capped": (CAPPED, ("density_kernel_t<capped>", "force_kernel_t<capped>")),
    "fused": (FUSED, ("density_kernel_t<prepass>", "fused_kernel_t")),
}


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


def agree(label: str, name: str, kernel, twin, counts=None, bar=RHO_BAR
          ) -> float:
    """Check one kernel output against its twin's; returns the max abs
    error.  ``counts`` is (kernel, twin) neighbor counts, which must be
    equal."""
    r = rel_l2(kernel, twin)
    line = f"[{label}] {name} vs twin: rel_l2={r:.3e}"
    if counts is not None:
        equal = bool((counts[0] == counts[1]).all())
        line += (f" counts_equal={equal} "
                 f"mean_neighbors={counts[0].float().mean().item():.3f}")
        check(equal, f"{label}: {name} neighbor counts kernel == twin")
    print(line)
    check(r <= bar, f"{label}: {name} rel-L2 {r} <= {bar}")
    return max_abs(kernel, twin)


def exact_vs_twins(cfg, p, label: str):
    """Exact K1 and K2 against their twins on the same card tensors.
    Returns the max abs errors and the arguments used (for timing)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc)
    rho_k, nc_k = sw.density_t(*args_d)
    rho_p, nc_p = sw.density_t_plain(*args_d)
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_k, p.mass_s)
    args_f = (cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.ws, p.wc)
    acc_k, acc_p = sw.force_t(*args_f), sw.force_t_plain(*args_f)
    torch.cuda.synchronize()
    print(f"[{label}] max_wc={p.wc.max().item()}")
    errs = {"density_kernel_t": agree(label, "density_kernel_t", rho_k, rho_p,
                                      (nc_k, nc_p)),
            "force_kernel_t": agree(label, "force_kernel_t", acc_k, acc_p,
                                    bar=ACC_BAR)}
    return errs, {"density_kernel_t": args_d, "force_kernel_t": args_f}


def capped_vs_twins(cfg, p, label: str):
    """The four capped kernels against their twins on the same card
    tensors, and K3's rho/counts against capped K1's.  Returns the max abs
    errors and the arguments used (for timing)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    pos_c, vel_c = sw.gather_sub_pv(p)
    n_kept = int((p.cand_cid >= 0).sum())
    print(f"[{label}] window={cfg.pallas_window_t} block={cfg.pallas_block_t} "
          f"S={p.sub_perm.shape[0]} kept={n_kept} "
          f"sub_dropped={int(p.sub_dropped)} max_wc={p.wc.max().item()} "
          f"max_wc_sub={p.wc_sub.max().item()}")
    args = {
        "density_kernel_t<capped>": (cfg, p.pos_s, p.mass_s, p.cid, p.ws,
                                     p.wc, pos_c, p.wm_sub, p.cand_cid,
                                     p.sub_perm),
        "density_kernel_t<prepass>": (cfg, pos_c, p.mass_s[p.sub_perm],
                                      p.wm_sub, p.cand_cid, p.sub_perm,
                                      p.ws_sub, p.wc_sub),
    }
    rho_k, nc_k = sw.density_capped_t(*args["density_kernel_t<capped>"])
    rho_p, nc_p = sw.density_t_plain(*args["density_kernel_t<capped>"])
    sub_k = sw.density_pre_t(*args["density_kernel_t<prepass>"])
    sub_p = sw.density_pre_t_plain(*args["density_kernel_t<prepass>"])
    # the force candidates' densities: rho at their sorted rows (two-pass)
    # or the pre-pass output (fused)
    cand_2 = sw.fused_cand_cols(cfg, pos_c, vel_c, rho_k[p.sub_perm], p.wm_sub)
    cand_f = sw.fused_cand_cols(cfg, pos_c, vel_c, sub_k, p.wm_sub)
    args["force_kernel_t<capped>"] = (cfg, p.pos_s, p.vel_s, rho_k, cand_2,
                                      p.cid, p.ws, p.wc, p.cand_cid,
                                      p.sub_perm)
    args["fused_kernel_t"] = (cfg, p.pos_s, p.vel_s, p.mass_s, p.cid, p.ws,
                              p.wc, cand_f, p.cand_cid, p.sub_perm)
    acc_k = sw.force_capped_t(*args["force_kernel_t<capped>"])
    acc_p = sw.force_t_plain(*args["force_kernel_t<capped>"])
    facc_k, frho_k, fnc_k = sw.fused_t(*args["fused_kernel_t"])
    facc_p, frho_p, fnc_p = sw.fused_t_plain(*args["fused_kernel_t"])
    torch.cuda.synchronize()
    errs = {
        "density_kernel_t<capped>": agree(label, "density_kernel_t<capped>",
                                          rho_k, rho_p, (nc_k, nc_p)),
        "force_kernel_t<capped>": agree(label, "force_kernel_t<capped>",
                                        acc_k, acc_p, bar=ACC_BAR),
        # the tail rows' pre-pass values feed no pair: kept rows only
        "density_kernel_t<prepass>": agree(
            label, "density_kernel_t<prepass> (kept rows)", sub_k[:n_kept],
            sub_p[:n_kept]),
        "fused_kernel_t": max(
            agree(label, "fused_kernel_t rho", frho_k, frho_p, (fnc_k, fnc_p)),
            agree(label, "fused_kernel_t acc", facc_k, facc_p, bar=ACC_BAR)),
    }
    bits = (bool(torch.equal(frho_k, rho_k)), bool(torch.equal(fnc_k, nc_k)))
    print(f"[{label}] fused K3 vs two-pass capped K1 on the same tensors: "
          f"rho bit-equal={bits[0]} counts equal={bits[1]} "
          f"rho rel_l2={rel_l2(frho_k, rho_k):.3e}; K3 acc vs capped K2 acc "
          f"rel_l2={rel_l2(facc_k, acc_k):.3e}")
    check(bits[1], f"{label}: fused counts == two-pass capped counts")
    check(rel_l2(frho_k, rho_k) <= RHO_BAR,
          f"{label}: fused rho vs two-pass capped rho")
    return errs, args


def timed(args: dict) -> dict:
    """{name: (kernel ms, twin ms)} at the given arguments of each kernel."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    out = {}
    for name, a in args.items():
        kern, twin = (getattr(sw, f) for f in KERNELS[name][:2])
        out[name] = (time_ms(lambda: kern(*a), 10),
                     time_ms(lambda: twin(*a), 3))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise
    from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import (
        cell_coords, linear_cell_id)
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils import build
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_sweep_settings, run_benchmark)

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

    def oracle(label, cfg, st):
        """Step quantities against the pairwise oracle (hydro only)."""
        acc, rho, nc, trunc = sw.compute_step_quantities(cfg, st)
        rho_o = pairwise.compute_density(cfg, st)
        nc_o = pairwise.neighbor_counts(cfg, st)
        acc_o = pairwise.compute_acceleration(cfg, st, rho_o)
        r_rho, r_acc = rel_l2(rho, rho_o), rel_l2(acc, acc_o)
        print(f"[{label}] vs pairwise: counts_equal="
              f"{bool((nc == nc_o).all())} rho_rel_l2={r_rho:.3e} "
              f"acc_rel_l2={r_acc:.3e} truncated={int(trunc)}")
        check(bool((nc == nc_o).all()), f"{label}: counts == pairwise")
        check(r_rho <= RHO_BAR, f"{label}: rho rel-L2 {r_rho} <= {RHO_BAR}")
        check(r_acc <= ACC_BAR, f"{label}: acc rel-L2 {r_acc} <= {ACC_BAR}")
        check(int(trunc) == 0, f"{label}: no candidates dropped")

    small = dict(cell_size_factor=1.25, pallas_window_t=64, grid_nx=32,
                 grid_ny=32, grid_nz=32)
    oracle_kw = dict(num_particles=4096, cell_size_factor=1.25,
                     pallas_window_t=64, grid_nx=16, grid_ny=16, grid_nz=16,
                     gravity=(0.0, 0.0, 0.0))

    # 2. exact kernels vs twins, 32k splash (packed pool: 32^3 grid of 1.25h
    #    cells; 64-row windows so multi-chunk walks are exercised)
    cfg, st = make_scene("splash", device=dev, num_particles=32768, **small)
    exact_vs_twins(cfg, sw.prepare_t(cfg, st), "exact 32k")

    # 3. exact kernels vs the pairwise oracle, n = 4096
    cfg, st = make_scene("splash", device=dev, **oracle_kw)
    oracle("exact 4096", cfg, st)

    # 4. the exact main path's shapes: agreement and times, kernel vs twin
    cfg, st = make_scene("splash", device=dev, **MAIN)
    errs, args = exact_vs_twins(cfg, sw.prepare_t(cfg, st), "exact 1M")
    times = timed(args)
    del args

    # 5. capped kernels vs twins, 32k splash (derived sub frame, with tail)
    ov = dict(small, num_particles=32768, capped_candidates=4,
              capped_fused=True, pallas_block_t=256)
    cfg, st = make_scene("splash", device=dev, **ov)
    cfg = resolve_sweep_settings(cfg, st, ov)
    capped_vs_twins(cfg, sw.prepare_t(cfg, st), "capped 32k")

    # 6. a keep-all cap against the pairwise oracle, two-pass and fused
    cfg, st = make_scene("splash", device=dev, **oracle_kw)
    cid = linear_cell_id(cfg, cell_coords(cfg, st.position))
    k_all = int(torch.bincount(cid.long()).max())
    for fused in (False, True):
        oracle(f"keep-all cap K_c={k_all} fused={fused} 4096",
               cfg.replace(capped_candidates=k_all, capped_fused=fused,
                           pallas_block_t=256), st)

    # 7. the capped main path's shapes: agreement, times, unbiasedness
    cfg, st = make_scene("splash", device=dev, **FUSED)
    cfg = resolve_sweep_settings(cfg, st, FUSED)
    p = sw.prepare_t(cfg, st)
    capped_errs, args = capped_vs_twins(cfg, p, "capped 1M")
    errs.update(capped_errs)
    times.update(timed(args))
    exact = cfg.replace(capped_candidates=0)
    rho_e = sw.density_sweep_t(exact, sw.prepare_t(exact, st))[0]
    rho_c = sw.density_sweep_t(cfg.replace(capped_fused=False), p)[0]
    ratio = rho_c.double().mean().item() / rho_e.double().mean().item()
    print(f"[capped 1M] capped rho mean / exact rho mean on the same state: "
          f"{ratio:.6f}")
    check(0.99 < ratio < 1.01, f"capped density unbiased: ratio {ratio}")
    for name, (k_ms, p_ms) in times.items():
        print(f"[1M] {name}: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms")
    del p, args, st, rho_e, rho_c

    # 8. the main paths, counted
    launches = {}
    for path, (ov, names) in PATHS.items():
        for wrapper in sw.WRAPPERS:
            wrapper.launches = 0
        r = run_benchmark(scene="splash", lazy=True, steps=STEPS,
                          warmup=WARMUP, overrides=ov, device="cuda")
        counts = {name: getattr(sw, KERNELS[name][0]).launches
                  for name in KERNELS}
        total_steps = r["warmup_steps"] + r["steps"]
        print(f"[main {path}] 1M splash lazy: {r['ms_per_step']:.4f} ms/step, "
              f"{r['value']:.6e} particle-steps/s over {r['steps']} steps "
              f"(warmup {r['warmup_steps']} steps, {r['warmup_s']:.2f} s); "
              f"window {r['window_t']} block {r['block_t']} sub_len "
              f"{r['capped_sub_len']}; rebins in timed steps {r['rebins']}; "
              f"launches {counts} for {total_steps} steps; max truncated "
              f"{max(r['truncated_ranges'])}; neighbor mean "
              f"{r['neighbor_mean'][-1]:.4f}; KE {r['kinetic_energy'][0]:.6e} "
              f"-> {r['kinetic_energy'][-1]:.6e}; finite={r['finite']}")
        for name in names:
            check(counts[name] == total_steps, f"{path}: {name} launched "
                  f"{counts[name]} times in {total_steps} steps")
            launches[name] = counts[name]
        check(len(r["truncated_ranges"]) == total_steps
              and max(r["truncated_ranges"]) == 0,
              f"{path}: truncated_ranges {r['truncated_ranges']}")
        check(r["finite"], f"{path}: positions, velocities and KE finite")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name, (_, _, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
