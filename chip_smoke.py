#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (every failed check raises, and the script exits nonzero):

1. build the kernels (``csrc/sweep_t.cu``, ``csrc/sweep_lane.cu``,
   ``csrc/probes.cu``) with nvcc, one process per source, started together;
   print the build time and ptxas's register/spill report;
2. exact mode, 32k splash: K1 and K2, the per-lane band walks
   (``density_band_t``, ``force_band_t``), against their plain PyTorch twins
   on the card (neighbor counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <=
   1e-4) and against the block-walk kernels (``density_kernel_t`` and
   ``force_kernel_t`` with ``EXCL_ROW``) on the same tensors: counts, rho
   and acc bit-equal;
3. exact mode, 4096-particle splash: the kernel-backed step quantities
   against the O(N^2) pairwise oracle, with the same bars;
4. exact mode, 1M splash shapes: the same checks at the main path's
   shapes, the rows tested per lane (band mean and max over a warp) beside
   the block window's rows per thread, and the kernel, block-walk and twin
   times (CUDA events);
5. capped mode (K_c = 4), 32k splash: capped K1 and K2, the per-lane band
   walks over the sub frame (``density_band_t<capped>``,
   ``force_band_t<capped>``), the fused path's pre-pass K1 and K3, band
   walks over the same table (``density_band_t<prepass>``,
   ``fused_band_t``), against their twins, and against the block-walk
   kernels on the same tensors: capped K1 and K2 against
   ``density_kernel_t``/``force_kernel_t`` with ``EXCL_SRC`` and K3 against
   ``fused_kernel_t`` (counts, rho and acc bit-equal on every row), the
   pre-pass against ``density_kernel_t`` with ``EXCL_SRC_SRC`` (rho and
   counts bit-equal on the kept sub rows; the tail rows count 0); K3's rho
   and counts bit-equal to capped K1's; the pre-pass's rows per thread and
   lane;
6. capped mode, 4096-particle splash with a keep-all cap (K_c = the largest
   cell occupancy), two-pass and fused, against the pairwise oracle;
7. capped mode, 1M splash shapes: the same checks, the rows tested per
   lane beside the block window's rows per thread, the kernel and twin
   times, the four capped band walks and their block walks timed in turns,
   and the capped density mean over the exact one on the same state in
   (0.99, 1.01) (the sampling is unbiased);
8. lane layout, 32k packed splash with 128-row windows (multi-chunk) and the
   1M lane splash shapes (window 512): the per-lane band walks
   ``density_band_lane`` and ``force_band_lane`` against their twins and,
   on the same tensors, bit-equal to the block walks ``density_kernel_lane``
   and ``force_kernel_lane`` (counts, rho, acc); then a clamped case (a few
   16^3-grid cells each holding more than 127 windows of rows, so
   ``truncated_ranges`` > 0), bit-equal to the block walks; the rows tested
   per lane at 1M (band mean, max over a warp, warp union) beside the block
   walk's rows per thread, kernel and twin times, and the band and block
   walks timed in turns;
9. backend parity: ``run_parity_check`` on the 32k disk (sublane kernels
   against the cell-list sweeps), then lane against cell-list and lane
   against sublane on the same states of the 32k disk and the 100k dam
   break, with the same bars;
10. the main paths, each with the launch counters reset just before:
   ``run_benchmark`` drives the 1M lazy splash (3 warmup + 20 timed steps)
   exact, capped two-pass and capped fused (bench.py's ``capped_k4`` row:
   block 256, window and sub-frame length derived), then the 1M lane splash
   eager (rebinned every step) for 3 + 20 steps.  Each kernel of a path
   must have launched once per step, no block walk of ``ops/sweeps_t.py``
   (``density_kernel_t``, ``force_kernel_t``, ``fused_kernel_t``) on any
   path, no step may drop candidates
   (``truncated_ranges`` 0) and the final state must be finite; after the
   capped run, one lazy step from the same state, capped and exact, must
   give densities whose means agree within 1 %.  Last, the
   32k disk runs 100 steps under the lazy sublane driver (central gravity,
   ``second_kick="gravity"``), printing KE, PE and |L| at the start and
   the end, with a finite state;
11. the distributed slab engine's six kernel callers (``parallel/
   slab_sweeps.py``: exact K1/K2, the band walks ``density_band_t`` and
   ``force_band_t`` over the live rows of a rank's extended frame; capped
   K1/K2, the same band walks with ``kExclSrc`` over the sub frame's
   cell-start table (``SubBand``, ``self_base = h_cap``); the sub-frame
   pre-pass K1 and K3, the band walks ``density_band_t<kExclSrcSrc>`` and
   ``fused_band_t`` over the same table) against their twins on
   the 1M splash at world size 1 (bench.py's ``slab_1dev`` and
   ``slab_capped_k4`` geometry: occupancy split, caps at headroom 1.05,
   window derived, K_c 4 on 256-row blocks): counts equal, rho rel-L2 <=
   1e-6, acc rel-L2 <= 1e-4 (the exact pair on the live rows), every row
   finite; kernel and twin times with their bounds.  The exact band walks
   also against the ``EXCL_ROW`` block walks over the raw frame on the
   same tensors: counts, rho and acc bit-equal on the live rows, the dead
   rows 0; the capped ones against the ``EXCL_SRC`` block walks over the
   sub frame: bit-equal on every own row; the fused pair against its block
   walks (``EXCL_SRC_SRC`` and ``fused_kernel_t``): the pre-pass bit-equal
   on the kept rows, K3 on every own row; rows tested per lane (band mean,
   max over a warp, warp union) beside the block walk's per thread and
   equal to the single-chip band walks' on the same state (capped: the
   same cell-start table too); band and block walks timed in turns (the
   exact band kernels launched on the live rows the wrappers gather, so
   time and bound are the kernels').  Then the engine's 4 ranks
   (``spawn_ranks``, gloo, all on cuda:0, each with its own
   ``prepare_frame``) on a box whose rank-1 corner cells are populated and
   whose ranks 0 and 2 hold fewer rows than ``h_cap``
   (``walk_stats.corner_state``): the same bit-equalities on every rank,
   exact, capped and fused, and the rows a table over the raw frame would
   test on rank 1;
12. the slab engine at world size 1 (an NCCL group of one rank) against the
   single-chip lazy step, one step from the same 1M splash state, exact and
   capped: neighbor mean, max and min equal to the single-chip counts', KE
   and PE rel <= 1e-5, collected positions rel-L2 <= 1e-6;
13. two ranks on the one card (``spawn_ranks``, gloo, both on cuda:0; NCCL
   refuses two ranks on one device): the 32k splash on its 32^3 grid, exact,
   capped and fused, a rebuild step and a frozen step, against the same
   engine at world size 1 on the same state: neighbor stats equal, KE rel
   <= 1e-5, no counted loss, every original id held exactly once.  The
   exact run's band kernels launch twice on each rank, with live halo rows
   (``nl``, ``nr``) on the inner sides;
14. the slab main paths, launch counters reset just before each:
   ``run_slab_benchmark`` on the 1M splash at world size 1 (NCCL group of
   one), exact, capped (K_c 4, 256-row blocks) and capped fused, 3 warmup +
   20 timed steps: each kernel of a path launched once per step, no block
   walk launched, no counted loss, a finite state; then
   the single-chip lazy step and the slab step
   in turns (single, slab, slab, single), exact, printing ms/step each;
15. the hardware probes (``tools/probe_{vpu_ops,gather,mxu}.py``, no step
   path runs them) at the JAX probes' shapes: every chain op over
   [131072, 128] at K = 1 and 4 (and the IEEE ops at the probe's K = 64)
   and the reciprocal table against the plain chain (bit-equal where both
   round in IEEE f32, rel <= 1e-5 where the kernel approximates); every
   gather mode and the one-shot reference (``ONESHOT``, the first design
   of ``gather_smem``) at each S, lane-varying and lane-uniform indices,
   bit-equal, ``gather_smem`` also on a grid of ``WALK_GRID`` CTAs (each
   walks many tiles round its ring, the tiles no multiple of the grid);
   each d^2 mode at one tile and over 4096 tiles, <= 1e-4 max abs against
   its plain version (FMA and 3xTF32 against the f32 one too);
   ``gather_smem`` (the persistent TMA pipeline) and the one-shot kernel
   in turns at every S, on rotating copies of their inputs (the bytes
   from device memory, not L2); the one-shot gather, ``torch.gather`` and
   the center-term chain under the queued timer (its sleep must outlast
   the enqueue); every step's values of the chains
   with IEEE slow paths inside their fast paths' range; then, launch
   counters reset, the three probes' main runs, whose every line and
   finding is printed, and the SASS of the chain kernels (sqrtf and '/'
   IEEE sequences, no chain folded: each MUFU op issues a full unrolled
   body of its MUFU instructions; each counted unrolled body, which the
   chain bounds come from, at least its ``MIX`` floor).

It then prints the card's name and power limit, one JSON line of kernel
records (time, twin time, launches, error, and the bound: the larger of the
bytes each call must move over 3.35 TB/s and the flops on the pairs within
h over 67 TFLOP/s f32, the H100 SXM's published peaks; for a probe, at the
case its record names, the chain's instructions counted from its unrolled
body's SASS over the card's issue rates (f32, MUFU and integer work;
control left out), the gather's bytes, or the d^2
tile's tensor-core flops over 495 TFLOP/s TF32, and the PyTorch call that
computes the same function as ``library_ms``), and last ``{"ok": true,
"device": {...}}``.  With no CUDA device it exits 1 before printing any result.
On every exit it stops the resource tracker that the spawned ranks started,
so no process of the script outlives it.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import torch

# the H100 SXM's published peaks (HBM bytes/s, f32 FLOP/s outside the tensor
# cores), the CUDA-event timer and the error measure, shared with the probes
from smoothed_particle_hydrodynamics_tpu_torch.tools import (
    F32_FLOPS, HBM_BYTES_PER_S, max_abs, time_ms)

# the main paths: bench.py's headline row (1M splash, lazy rebinning, 1.25h
# cells) and its capped_k4 row, two-pass and fused; the lane layout's eager
# 1M splash on its own 1.0h cells with the JAX defaults (window 512, 128-row
# blocks)
MAIN = dict(num_particles=1_000_000, cell_size_factor=1.25, pallas_window_t=208)
CAPPED = dict(num_particles=1_000_000, cell_size_factor=1.25,
              capped_candidates=4, pallas_window_t=0)
FUSED = dict(CAPPED, capped_fused=True)
LANE = dict(num_particles=1_000_000, pallas_layout="lane")
WARMUP, STEPS = 3, 20
DISK_STEPS = 100
RHO_BAR, ACC_BAR = 1e-6, 1e-4
PKG = "smoothed_particle_hydrodynamics_tpu_torch"
SOURCE_T = f"{PKG}/csrc/sweep_t.cu"
SOURCE_LANE = f"{PKG}/csrc/sweep_lane.cu"
SOURCE_PROBES = f"{PKG}/csrc/probes.cu"
TPU_T = "smoothed_particle_hydrodynamics_tpu/ops/pallas_step_t.py"
TPU_LANE = "smoothed_particle_hydrodynamics_tpu/ops/pallas_step.py"
TPU_SLABS = "smoothed_particle_hydrodynamics_tpu/parallel/slabs.py"
# the slab engine's main paths: bench.py's slab_1dev row (1M splash, one
# rank, window derived, headroom 1.05) and its slab_capped_k4 row, fused too
SLAB = dict(cell_size_factor=1.25)
SLAB_CAPPED = dict(cell_size_factor=1.25, capped_candidates=4,
                   pallas_block_t=256, pallas_window_t=0)
SLAB_FUSED = dict(SLAB_CAPPED, capped_fused=True)
SLAB_HEADROOM = 1.05
# the populated-corner split's capped frames (phase 11): K_c 4 on the
# capped main path's 256-row blocks, fused (its tables hold the two-pass
# ones too)
CORNER_CAPPED = dict(capped_candidates=4, pallas_block_t=256,
                     pallas_window_t=32, capped_fused=True)


class Kernel(NamedTuple):
    module: str          # "t" (ops/sweeps_t.py), "lane" (ops/sweeps_lane.py),
    #                      "slab" (parallel/slab_sweeps.py) or a probe
    #                      ("vpu", "gather", "mxu": tools/probe_*.py)
    wrapper: str
    twin: str
    source: str
    replaces: str        # TPU kernel file:line
    flops_per_pair: int  # f32 operations on a pair within h, from the source
    caller: str = ""     # the JAX caller of a slab kernel, file:line


KERNELS = {
    "density_band_t": Kernel("t", "density_t", "density_t_plain", SOURCE_T,
                             f"{TPU_T}:293", 15),
    "force_band_t": Kernel("t", "force_t", "force_t_plain", SOURCE_T,
                           f"{TPU_T}:360", 36),
    "density_band_t<capped>": Kernel("t", "density_capped_t",
                                     "density_t_plain", SOURCE_T,
                                     f"{TPU_T}:321", 15),
    "force_band_t<capped>": Kernel("t", "force_capped_t", "force_t_plain",
                                   SOURCE_T, f"{TPU_T}:403", 36),
    "density_band_t<prepass>": Kernel("t", "density_pre_t",
                                      "density_pre_t_plain", SOURCE_T,
                                      f"{TPU_T}:318", 15),
    "fused_band_t": Kernel("t", "fused_t", "fused_t_plain", SOURCE_T,
                           f"{TPU_T}:497", 48),
    "density_band_lane": Kernel("lane", "density_lane", "density_lane_plain",
                                SOURCE_LANE, f"{TPU_LANE}:196", 15),
    "force_band_lane": Kernel("lane", "force_lane", "force_lane_plain",
                              SOURCE_LANE, f"{TPU_LANE}:244", 40),
    # the slab engine's callers of K1/K2/K3 (one Pallas call site)
    "density_band_t[slab]": Kernel(
        "slab", "density_ext", "density_ext_plain", SOURCE_T,
        f"{TPU_SLABS}:570", 15, f"{TPU_SLABS}:494"),
    "force_band_t[slab]": Kernel(
        "slab", "force_ext", "force_ext_plain", SOURCE_T, f"{TPU_SLABS}:570",
        36, f"{TPU_SLABS}:588"),
    "density_band_t<capped>[slab]": Kernel(
        "slab", "density_ext_capped", "density_ext_capped_plain", SOURCE_T,
        f"{TPU_SLABS}:570", 15, f"{TPU_SLABS}:663"),
    "force_band_t<capped>[slab]": Kernel(
        "slab", "force_ext_capped", "force_ext_capped_plain", SOURCE_T,
        f"{TPU_SLABS}:570", 36, f"{TPU_SLABS}:704"),
    "density_band_t<prepass>[slab]": Kernel(
        "slab", "density_sub_pre", "density_sub_pre_plain", SOURCE_T,
        f"{TPU_SLABS}:570", 15, f"{TPU_SLABS}:750"),
    "fused_band_t[slab]": Kernel(
        "slab", "fused_ext", "fused_ext_plain", SOURCE_T, f"{TPU_SLABS}:570",
        48, f"{TPU_SLABS}:792"),
    # the hardware probes: no step path runs them (no flops per pair)
    "chain_kernel": Kernel("vpu", "chain", "chain_plain", SOURCE_PROBES,
                           "tools/probe_vpu_ops.py:36", 0),
    "gather_tile_kernel": Kernel("gather", "gather_tile", "gather_tile_plain",
                                 SOURCE_PROBES, "tools/probe_gather.py:40", 0),
    "d2_tile_kernel": Kernel("mxu", "d2_tile", "d2_tile_plain", SOURCE_PROBES,
                             "tools/probe_mxu.py:27", 0),
}
PROBE_KERNELS = ("chain_kernel", "gather_tile_kernel", "d2_tile_kernel")
# which kernels each main path runs (the first path a kernel is in gives its
# launch count in the kernels line)
PATHS = {
    "exact": (MAIN, ("density_band_t", "force_band_t")),
    "capped": (CAPPED, ("density_band_t<capped>", "force_band_t<capped>")),
    "fused": (FUSED, ("density_band_t<prepass>", "fused_band_t")),
    "lane": (LANE, ("density_band_lane", "force_band_lane")),
}
SLAB_PATHS = {
    "slab exact": (SLAB, ("density_band_t[slab]", "force_band_t[slab]")),
    "slab capped": (SLAB_CAPPED, ("density_band_t<capped>[slab]",
                                  "force_band_t<capped>[slab]")),
    "slab fused": (SLAB_FUSED, ("density_band_t<prepass>[slab]",
                                "fused_band_t[slab]")),
}


def _modules() -> dict:
    from smoothed_particle_hydrodynamics_tpu_torch.ops import (sweeps_lane,
                                                               sweeps_t)
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps)
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather, probe_mxu, probe_vpu_ops)

    return {"t": sweeps_t, "lane": sweeps_lane, "slab": slab_sweeps,
            "vpu": probe_vpu_ops, "gather": probe_gather, "mxu": probe_mxu}


def _module(name: str):
    return _modules()[KERNELS[name].module]


def wrapper(name: str):
    return getattr(_module(name), KERNELS[name].wrapper)


def reset_launches() -> None:
    for mod in _modules().values():
        for w in mod.WRAPPERS:
            w.launches = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


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


def band_vs_block(p, window: float, band: dict, block: dict,
                  band_out: tuple, label: str) -> None:
    """Print the rows each walk tests (``window``: the block walk's per
    thread; ``band``: per lane, mean, max over a warp, warp union, from
    ``utils/walk_stats.py``), and check the band kernels' (counts, rho, acc)
    bit-equal to the block-walk kernels' on the same tensors (``block``:
    kernel name -> launch)."""
    (rho_b, nc_b), acc_b = (f() for f in block.values())
    torch.cuda.synchronize()
    print(f"[{label}] max_wc={p.wc.max().item()} rows tested per thread: "
          f"block window {window:.1f}, band mean {band['mean']:.1f}, band "
          f"max over a warp {band['warp_max']:.1f}, warp union "
          f"{band['warp_union']:.1f}")
    nc_k, rho_k, acc_k = band_out
    bits = (bool(torch.equal(nc_b, nc_k)), bool(torch.equal(rho_b, rho_k)),
            bool(torch.equal(acc_b, acc_k)))
    print(f"[{label}] band kernels vs block-walk kernels on the same tensors:"
          f" counts, rho, acc bit-equal={bits}")
    check(all(bits), f"{label}: band walk vs block walk bit-equal {bits}")


def sublane_rows(cfg, p, m: int) -> tuple[float, dict]:
    """The sublane block walk's rows per thread and the band kernels' rows
    per lane over the m candidate rows."""
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        band_rows_per_lane, sublane_rows_per_thread)

    return (sublane_rows_per_thread(cfg, p, m),
            band_rows_per_lane(cfg, p.cid, p.cell_start, m))


def exact_vs_twins(cfg, p, label: str):
    """Exact K1 and K2, the band walks, against their twins and against the
    block-walk kernels on the same card tensors, which must give counts, rho
    and acc bit-equal to the band kernels'.  Returns the max abs errors, the
    kernel and twin arguments and the tensors each kernel reads (for timing
    and its bound), the pairs within h each kernel sums, and the block
    walk's launches by kernel name."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc, p.cell_start)
    rho_k, nc_k = sw.density_t(*args_d)
    rho_p, nc_p = sw.density_t_plain(*args_d[:-1])
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_k, p.mass_s)
    args_f = (cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.ws, p.wc,
              p.cell_start)
    acc_k, acc_p = sw.force_t(*args_f), sw.force_t_plain(*args_f[:-1])
    block = {
        "density_band_t": lambda: sw._launch_density(
            cfg, sw.EXCL_ROW, p.pos_s, p.mass_s, p.cid, p.ws, p.wc, p.pos_s,
            p.mass_s, p.cid, None, None, "density_kernel_t"),
        "force_band_t": lambda: sw._launch_force(
            cfg, sw.EXCL_ROW, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.ws,
            p.wc, p.cid, None, "force_kernel_t")}
    band_vs_block(p, *sublane_rows(cfg, p, p.pos_s.shape[0]), block,
                  (nc_k, rho_k, acc_k), label)
    errs = {"density_band_t": agree(label, "density_band_t", rho_k, rho_p,
                                    (nc_k, nc_p)),
            "force_band_t": agree(label, "force_band_t", acc_k, acc_p,
                                  bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    args = {"density_band_t": args_d, "force_band_t": args_f}
    twin_args = {name: a[:-1] for name, a in args.items()}
    # the sums need the rows and cids only: cell_start is the kernels' own
    # index, of which they read just the entries next to occupied cells
    reads = {"density_band_t": (p.pos_s, p.mass_s, p.cid),
             "force_band_t": (p.pos_s, p.vel_s, rho_k, cand, p.cid)}
    return (errs, (args, twin_args, reads),
            {"density_band_t": pairs, "force_band_t": pairs}, block)


def fused_vs_block(label: str, kept: int, pre_band: tuple, pre_block: tuple,
                   k3_band: tuple, k3_block: tuple, rows: tuple) -> None:
    """The fused pair's band walks against their block walks on the same
    card tensors: the pre-pass's (rho, counts) bit-equal on the ``kept``
    sub rows (the tail rows' bands are empty: they get the self term and
    count 0, the block walk what their windows hold), K3's (acc, rho,
    counts) on every row.  ``rows``: the pre-pass block walk's rows per
    thread and its band's ``band_stats`` (``walk_stats.prepass_rows``)."""
    window, band = rows
    print(f"[{label}] pre-pass rows tested per thread: block window "
          f"{window:.1f}, band mean {band['mean']:.1f}, band max over a warp "
          f"{band['warp_max']:.1f}, warp union {band['warp_union']:.1f}")
    k = slice(0, kept)
    pre = tuple(bool(torch.equal(a[k], b[k]))
                for a, b in zip(pre_band, pre_block))
    tail = not pre_band[1][kept:].any()
    k3 = tuple(bool(torch.equal(a, b)) for a, b in zip(k3_band, k3_block))
    print(f"[{label}] band walks vs block walks on the same tensors: pre-pass "
          f"rho, counts bit-equal on the kept rows={pre} (tail rows count 0="
          f"{tail}); K3 acc, rho, counts bit-equal={k3}")
    check(all(pre) and tail, f"{label}: pre-pass band vs block walk {pre}")
    check(all(k3), f"{label}: K3 band vs block walk bit-equal {k3}")


def capped_vs_twins(cfg, p, label: str):
    """The four capped kernels, all band walks over the sub frame's table,
    against their twins on the same card tensors and against the block-walk
    kernels (capped K1/K2 and K3 bit-equal on every row, the pre-pass on
    the kept rows), and K3's rho/counts against capped K1's (bit-equal).
    Returns the max abs errors, the kernel and twin arguments and the
    tensors each kernel reads (for timing and its bound), the pairs within
    h each kernel sums, and the block walk's launches by kernel name."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        prepass_rows)

    pos_c, vel_c = sw.gather_sub_pv(p)
    mass_c = p.mass_s[p.sub_perm]
    n_kept = int((p.cand_cid >= 0).sum())
    print(f"[{label}] window={cfg.pallas_window_t} block={cfg.pallas_block_t} "
          f"S={p.sub_perm.shape[0]} kept={n_kept} "
          f"sub_dropped={int(p.sub_dropped)} max_wc={p.wc.max().item()} "
          f"max_wc_sub={p.wc_sub.max().item()}")
    args = {
        "density_band_t<capped>": (cfg, p.pos_s, p.mass_s, p.cid, p.ws, p.wc,
                                   pos_c, p.wm_sub, p.cand_cid, p.sub_perm,
                                   p.cell_start),
        "density_band_t<prepass>": (cfg, pos_c, mass_c, p.wm_sub, p.cand_cid,
                                    p.sub_perm, p.ws_sub, p.wc_sub,
                                    p.cell_start),
    }
    rho_k, nc_k = sw.density_capped_t(*args["density_band_t<capped>"])
    rho_p, nc_p = sw.density_t_plain(*args["density_band_t<capped>"][:-1])
    sub_k = sw.density_pre_t(*args["density_band_t<prepass>"])
    # the pre-pass band walk's and twin's counts: their launches direct
    sub_bk, sub_nk = sw._launch_density_band(
        cfg, pos_c, mass_c, p.cand_cid, p.cell_start, pos_c, p.wm_sub,
        p.sub_perm, "density_band_t<prepass>", self_src=p.sub_perm)
    sub_p, sub_nc = sw.density_t_plain(
        cfg, pos_c, mass_c, p.cand_cid, p.ws_sub, p.wc_sub, pos_c, p.wm_sub,
        p.cand_cid, p.sub_perm, p.sub_perm)
    # the force candidates' densities: rho at their sorted rows (two-pass)
    # or the pre-pass output (fused)
    cand_2 = sw.fused_cand_cols(cfg, pos_c, vel_c, rho_k[p.sub_perm], p.wm_sub)
    cand_f = sw.fused_cand_cols(cfg, pos_c, vel_c, sub_k, p.wm_sub)
    args["force_band_t<capped>"] = (cfg, p.pos_s, p.vel_s, rho_k, cand_2,
                                    p.cid, p.ws, p.wc, p.cand_cid,
                                    p.sub_perm, p.cell_start)
    args["fused_band_t"] = (cfg, p.pos_s, p.vel_s, p.mass_s, p.cid, p.ws,
                            p.wc, cand_f, p.cand_cid, p.sub_perm,
                            p.cell_start)
    acc_k = sw.force_capped_t(*args["force_band_t<capped>"])
    acc_p = sw.force_t_plain(*args["force_band_t<capped>"][:-1])
    fused_k = sw.fused_t(*args["fused_band_t"])
    facc_k, frho_k, fnc_k = fused_k
    facc_p, frho_p, fnc_p = sw.fused_t_plain(*args["fused_band_t"][:-1])
    torch.cuda.synchronize()
    block = {
        "density_band_t<capped>": lambda: sw._launch_density(
            cfg, sw.EXCL_SRC, p.pos_s, p.mass_s, p.cid, p.ws, p.wc, pos_c,
            p.wm_sub, p.cand_cid, p.sub_perm, None,
            "density_kernel_t<capped>"),
        "force_band_t<capped>": lambda: sw._launch_force(
            cfg, sw.EXCL_SRC, p.pos_s, p.vel_s, rho_k, cand_2, p.cid, p.ws,
            p.wc, p.cand_cid, p.sub_perm, "force_kernel_t<capped>"),
        "density_band_t<prepass>": lambda: sw._launch_density(
            cfg, sw.EXCL_SRC_SRC, pos_c, mass_c, p.cand_cid, p.ws_sub,
            p.wc_sub, pos_c, p.wm_sub, p.cand_cid, p.sub_perm, p.sub_perm,
            "density_kernel_t<prepass>"),
        "fused_band_t": lambda: sw._launch_fused(
            cfg, p.pos_s, p.vel_s, p.mass_s, p.cid, p.ws, p.wc, cand_f,
            p.cand_cid, p.sub_perm, "fused_kernel_t")}
    pair = ("density_band_t<capped>", "force_band_t<capped>")
    band_vs_block(p, *sublane_rows(cfg, p, p.sub_perm.shape[0]),
                  {name: block[name] for name in pair},
                  (nc_k, rho_k, acc_k), label)
    check(bool(torch.equal(sub_bk, sub_k)),
          f"{label}: pre-pass wrapper == its launch")
    fused_vs_block(label, n_kept, (sub_k, sub_nk),
                   block["density_band_t<prepass>"](), fused_k,
                   block["fused_band_t"](),
                   prepass_rows(cfg, p.cand_cid, p.ws_sub, p.wc_sub,
                                p.cell_start))
    errs = {
        "density_band_t<capped>": agree(label, "density_band_t<capped>",
                                        rho_k, rho_p, (nc_k, nc_p)),
        "force_band_t<capped>": agree(label, "force_band_t<capped>",
                                      acc_k, acc_p, bar=ACC_BAR),
        # the tail rows' pre-pass values feed no pair: kept rows only
        "density_band_t<prepass>": agree(
            label, "density_band_t<prepass> (kept rows)", sub_k[:n_kept],
            sub_p[:n_kept], (sub_nk[:n_kept], sub_nc[:n_kept])),
        "fused_band_t": max(
            agree(label, "fused_band_t rho", frho_k, frho_p, (fnc_k, fnc_p)),
            agree(label, "fused_band_t acc", facc_k, facc_p, bar=ACC_BAR)),
    }
    # both band walks sum the same pairs in the same order
    bits = (bool(torch.equal(frho_k, rho_k)), bool(torch.equal(fnc_k, nc_k)))
    print(f"[{label}] fused K3 vs two-pass capped K1 on the same tensors: "
          f"rho bit-equal={bits[0]} counts equal={bits[1]} "
          f"rho rel_l2={rel_l2(frho_k, rho_k):.3e}; K3 acc vs capped K2 acc "
          f"rel_l2={rel_l2(facc_k, acc_k):.3e}")
    check(all(bits), f"{label}: fused rho, counts bit-equal to two-pass "
          f"capped K1's {bits}")
    capped = int(nc_k.sum())
    pairs = {"density_band_t<capped>": capped,
             "force_band_t<capped>": capped,
             "density_band_t<prepass>": int(sub_nk[:n_kept].sum()),
             "fused_band_t": int(fnc_k.sum())}
    twin_args = {name: args[name][:-1] for name in block}
    # the band sums need the rows, the self cids and the candidates' src
    # rows: cell_start is the kernels' own index (as for the exact walks)
    # and the candidates' cids are not read; the pre-pass's self rows are
    # its candidates (each sub row once: positions, true and reweighted
    # masses, cids, src rows)
    reads = {"density_band_t<capped>": (p.pos_s, p.mass_s, p.cid, pos_c,
                                        p.wm_sub, p.sub_perm),
             "force_band_t<capped>": (p.pos_s, p.vel_s, rho_k, p.cid, cand_2,
                                      p.sub_perm),
             "density_band_t<prepass>": (pos_c, mass_c, p.wm_sub, p.cand_cid,
                                         p.sub_perm),
             "fused_band_t": (p.pos_s, p.vel_s, p.mass_s, p.cid, cand_f,
                              p.sub_perm)}
    return errs, (args, twin_args, reads), pairs, block


def lane_vs_twins(cfg, st, label: str, twins: bool = True):
    """The lane band kernels on the card against the block-walk kernels on
    the same tensors, which must give counts, rho and acc bit-equal, and
    (``twins``) against their twins, with no chunk cut by the 127 clamp.
    Returns the max abs errors, the kernel and twin arguments and the
    tensors each kernel reads (for timing and its bound), the pairs within
    h each kernel sums, and the block walk's launches by kernel name; or,
    without ``twins``, the chunks the clamp cut."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_lane as sl
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        lane_band_rows_per_lane, lane_rows_per_thread)

    p = sl.prepare_lane(cfg, st)
    n = st.n
    args_d = (cfg, sl.density_fields(cfg, p), p.ws, p.wc, n, p.cell_start)
    rho_k, nc_k = sl.density_lane(*args_d)
    args_f = (cfg, sl.force_fields(cfg, p, rho_k), p.ws, p.wc, n,
              p.cell_start)
    acc_k = sl.force_lane(*args_f)
    torch.cuda.synchronize()
    truncated = int(p.truncated_ranges)
    print(f"[{label}] n={n} window={cfg.pallas_window} "
          f"block={cfg.pallas_block_rows} truncated={truncated}")
    block = {"density_band_lane": lambda: sl.density_lane_block(*args_d[:-1]),
             "force_band_lane": lambda: sl.force_lane_block(*args_f[:-1])}
    band_vs_block(p, lane_rows_per_thread(cfg, p),
                  lane_band_rows_per_lane(cfg, p), block,
                  (nc_k, rho_k, acc_k), label)
    if not twins:
        return truncated
    check(truncated == 0, f"{label}: no chunk clamped")
    rho_p, nc_p = sl.density_lane_plain(*args_d[:-1])
    acc_p = sl.force_lane_plain(*args_f[:-1])
    errs = {"density_band_lane": agree(label, "density_band_lane", rho_k,
                                       rho_p, (nc_k, nc_p)),
            "force_band_lane": agree(label, "force_band_lane", acc_k, acc_p,
                                     bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    args = {"density_band_lane": args_d, "force_band_lane": args_f}
    # the sums need the field table and the window tables; cell_start is
    # the kernels' own index (as for the sublane band walks)
    twin_args = {name: a[:-1] for name, a in args.items()}
    return (errs, (args, twin_args, twin_args),
            {"density_band_lane": pairs, "force_band_lane": pairs}, block)


def clamped_lane_state(dev, cells: int = 3, per_cell: int = 17_000):
    """A lane frame whose windows the 127-chunk clamp cuts: the 4096-particle
    splash on a 16^3 grid of h-cells (window 128) plus ``cells`` cells each
    holding ``per_cell`` > 127 * 128 particles at positions jittered
    uniformly inside the cell, from a seeded generator."""
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState

    cfg, st = make_scene("splash", device=dev, num_particles=4096,
                         grid_nx=16, grid_ny=16, grid_nz=16,
                         pallas_layout="lane", pallas_window=128)
    g = torch.Generator(device=dev).manual_seed(8)
    corner = torch.tensor([[3, 4, 2], [9, 6, 5], [12, 11, 8]],
                          dtype=torch.float32, device=dev)[:cells]
    jitter = torch.rand(cells, per_cell, 3, generator=g, device=dev)
    pos = ((corner[:, None, :] + 0.02 + 0.96 * jitter) * cfg.cell_size
           ).reshape(-1, 3)
    vel = 0.01 * torch.randn(pos.shape, generator=g, device=dev)
    extra = ParticleState.from_arrays(pos, vel, cfg=cfg)
    st = ParticleState(*(torch.cat([a, b]) for a, b in zip(st, extra)))
    return cfg.replace(num_particles=st.n), st


def finite(label: str, name: str, *outs) -> None:
    for t in outs:
        check(bool(torch.isfinite(t.float()).all()),
              f"{label}: {name} output finite on every row")


def slab_exact_vs_block(cfg, group, frame, caps, label: str):
    """The slab engine's exact K1/K2, the band walks over the live rows of
    one rank's frame (``slabs.prepare_frame``), against their twins and
    against the ``EXCL_ROW`` block walks over the raw frame on the same
    card tensors: on the live own rows counts, rho and acc bit-equal to the
    block walks' and within the bars of the twins'; the dead rows 0 (the
    twins and block walks count dead rows within h of each other); every
    row finite.  The halo rows' densities come from the neighbours
    (``exchange_rho`` on ``group``).  Prints the rows tested per lane beside
    the block walk's per thread.  Returns the max abs errors, the wrapper
    arguments, the pairs within h, the band kernels' launches on the
    gathered live rows and the tensors each reads (for its time and bound:
    each live row once), the block walks' launches, both by kernel name, and
    the band statistics."""
    from types import SimpleNamespace

    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        slab_band_rows_per_lane, sublane_rows_per_thread)

    p_cap, h_cap, _ = caps
    ext, cid, f = frame.ext, frame.cid_ext, frame
    cnt = f.count
    ws, wc, band = f.tabs
    print(f"[{label}] p_cap={p_cap} h_cap={h_cap} count={cnt} "
          f"window={cfg.pallas_window_t} block={sw._blane(cfg)} "
          f"max_wc={wc.max().item()} live rows {band.rows.shape[0]} "
          f"(left halo {band.nl}, right halo {band.nr})")
    n_d, n_f = "density_band_t[slab]", "force_band_t[slab]"
    args = {n_d: ss.density_local_args(cfg, ext, cid, ws, wc, h_cap, p_cap,
                                       band)}
    rho_k, nc_k = ss.density_ext(*args[n_d])
    rho_p, nc_p = ss.density_ext_plain(*args[n_d])
    rho_e = slabs.exchange_rho(group, rho_k, cnt, h_cap)
    args[n_f] = ss.force_local_args(cfg, ext, cid, rho_e, rho_k, ws, wc,
                                    h_cap, p_cap, band)
    acc_k, acc_p = ss.force_ext(*args[n_f]), ss.force_ext_plain(*args[n_f])
    _, pos_l, mass_l, cid_l = args[n_d][:4]
    _, _, vel_l, _, cand = args[n_f][:5]
    cpos, cmass = ext[:, 0:3].contiguous(), ext[:, 6].contiguous()
    block = {
        n_d: lambda: sw._launch_density(
            cfg, sw.EXCL_ROW, pos_l, mass_l, cid_l, ws, wc, cpos, cmass, cid,
            None, None, "density_kernel_t[slab]", h_cap),
        n_f: lambda: sw._launch_force(
            cfg, sw.EXCL_ROW, pos_l, vel_l, rho_k, cand, cid_l, ws, wc, cid,
            None, "force_kernel_t[slab]", h_cap)}
    (rho_b, nc_b), acc_b = (fn() for fn in block.values())
    torch.cuda.synchronize()
    finite(label, n_d, rho_k, nc_k)
    finite(label, n_f, acc_k)
    live = slice(0, cnt)
    nlive = -(-cnt // sw._blane(cfg)) * 9
    window = sublane_rows_per_thread(
        cfg, SimpleNamespace(ws=ws[:nlive], wc=wc[:nlive]), ext.shape[0])
    stats = slab_band_rows_per_lane(cfg, band, cnt)
    print(f"[{label}] rows tested per thread (live blocks): block window "
          f"{window:.1f}, band mean {stats['mean']:.1f}, band max over a "
          f"warp {stats['warp_max']:.1f}, warp union "
          f"{stats['warp_union']:.1f}")
    bits = (bool(torch.equal(nc_b[live], nc_k[live])),
            bool(torch.equal(rho_b[live], rho_k[live])),
            bool(torch.equal(acc_b[live], acc_k[live])))
    dead = not (nc_k[cnt:].any() or rho_k[cnt:].any() or acc_k[cnt:].any())
    print(f"[{label}] band kernels vs EXCL_ROW block walks over the raw "
          f"frame on the same tensors: live rows counts, rho, acc bit-equal="
          f"{bits}; dead rows 0={dead}")
    check(all(bits), f"{label}: band walk vs block walk bit-equal {bits}")
    check(dead, f"{label}: dead rows write 0")
    errs = {n_d: agree(label, f"{n_d} (live rows)", rho_k[live], rho_p[live],
                       (nc_k[live], nc_p[live])),
            n_f: agree(label, f"{n_f} (live rows)", acc_k[live], acc_p[live],
                       bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    # the wrappers' launches on the live rows they gather: the own rows are
    # live rows [nl, nl + count), so the bound reads each live row once (the
    # self velocities too: the candidate columns hold m/rho * v) and, as on
    # one device, not cell_start, the kernels' own index
    pos_c, mass_c = ext[band.rows, 0:3], ext[band.rows, 6]
    cand_c = cand[band.rows]
    bands = {
        n_d: lambda: sw._launch_density_band(
            cfg, pos_l, mass_l, band.cid, band.cell_start, pos_c, mass_c,
            None, n_d, band.nl),
        n_f: lambda: sw._launch_force_band(
            cfg, pos_l, vel_l, rho_k, cand_c, band.cid, band.cell_start, None,
            n_f, band.nl)}
    reads = {n_d: (band.cid, pos_c, mass_c),
             n_f: (vel_l, rho_k, band.cid, cand_c)}
    return (errs, args, {n_d: pairs, n_f: pairs}, (bands, reads), block,
            stats)


def corner_rank(group, job: dict) -> dict:
    """On one rank of ``spawn_ranks``: its frame of ``job``'s state at the
    first step, built by the engine (``slabs.prepare_frame``), its exact
    band walks held against the twins and the block walks
    (``slab_exact_vs_block``), and, on rank 1, the rows a table over the
    raw frame would test; then its capped frame of the same state
    (``job["capped"]``: config, caps, sub-frame length; fused, so the frame
    holds both pairs' tables), its capped band walks held the same way
    (``slab_capped_vs_block``) and its fused pair against its block walks
    (``slab_fused_vs_twins``).  Returns the rank's count, live halo rows,
    band statistics (exact and capped) and (rank 1) its last cell's rows
    and the raw table's statistics."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs
    from smoothed_particle_hydrodynamics_tpu_torch.state import (
        state_from_numpy)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        band_rows_per_lane)

    cfg, caps, zs = job["cfg"], job["caps"], job["zsplit"]
    st = state_from_numpy(job["state"], group.device)
    carry = slabs.init_lazy_slab(
        cfg, group, slabs.distribute(cfg, st, group, caps[0], zs), caps[0],
        "pallas")
    frame = slabs.prepare_frame(cfg, group, *caps, "pallas", zs, True, 0,
                                carry)
    d = group.rank
    stats = slab_exact_vs_block(cfg, group, frame, caps,
                                f"slab corner rank {d}")[-1]
    band = frame.tabs[2]
    out = dict(count=frame.count, nl=band.nl, nr=band.nr, stats=stats)
    if d == 1:
        nxny = cfg.grid_nx * cfg.grid_ny
        out["top"] = int((frame.cid_s[:frame.count]
                          == zs[2] * nxny - 1).sum())
        raw = torch.searchsorted(frame.cid_ext, torch.arange(
            cfg.num_cells + 1, dtype=torch.int32, device=group.device),
            out_int32=True)
        out["raw"] = band_rows_per_lane(cfg, frame.cid_s[:frame.count], raw,
                                        frame.ext.shape[0])
    cap = job["capped"]
    carry = slabs.init_lazy_slab(
        cap["cfg"], group, slabs.distribute(cap["cfg"], st, group,
                                            cap["caps"][0], zs),
        cap["caps"][0], "pallas", cap["sub_len"])
    frame = slabs.prepare_frame(cap["cfg"], group, *cap["caps"], "pallas", zs,
                                True, cap["sub_len"], carry)
    out["capped_stats"] = slab_capped_vs_block(
        cap["cfg"], group, frame, cap["caps"],
        f"slab corner rank {d} capped")[-1]
    slab_fused_vs_twins(cap["cfg"], group, frame, cap["caps"],
                        f"slab corner rank {d} fused")
    return out


def slab_capped_vs_block(cfg, group, frame, caps, label: str):
    """The slab engine's capped K1/K2, the band walks over the sub frame's
    table (``SubBand``) of one rank's frame (``slabs.prepare_frame``),
    against their twins and against the ``EXCL_SRC`` block walks over the
    same sub frame on the same card tensors: counts, rho and acc bit-equal
    on every own row (the dead rows 0 on both) and within the bars of the
    twins'; every row finite.  The halo rows' densities come from the
    neighbours (``exchange_rho`` on ``group``).  Prints the rows tested per
    lane beside the block walk's per thread.  Returns the max abs errors,
    the wrapper arguments, the pairs within h, the tensors each band kernel
    reads (for its bound: each row once, not the table), the block walks'
    launches, all by kernel name, and the band statistics."""
    from types import SimpleNamespace

    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        slab_sub_band_rows_per_lane, sublane_rows_per_thread)

    p_cap, h_cap, _ = caps
    ext, cid, cnt = frame.ext, frame.cid_ext, frame.count
    ws, wc, sub_src, cand_cid, w_sub, sub_dropped, band = frame.tabs[:7]
    s_len = sub_src.shape[0]
    n_kept = int(band.cell_start[-1])
    print(f"[{label}] p_cap={p_cap} h_cap={h_cap} count={cnt} "
          f"window={cfg.pallas_window_t} block={sw._blane(cfg)} "
          f"max_wc={wc.max().item()} S={s_len} kept={n_kept} "
          f"sub_dropped={int(sub_dropped)}")
    check(n_kept == int((cand_cid >= 0).sum()),
          f"{label}: the table's kept count is the sub frame's")
    n_d, n_f = "density_band_t<capped>[slab]", "force_band_t<capped>[slab]"
    g8 = ext[sub_src.long()]
    args = {n_d: ss.density_local_capped_args(
        cfg, ext, g8, cid, ws, wc, sub_src, cand_cid, w_sub, h_cap, p_cap,
        band)}
    rho_k, nc_k = ss.density_ext_capped(*args[n_d])
    rho_p, nc_p = ss.density_ext_capped_plain(*args[n_d])
    rho_e = slabs.exchange_rho(group, rho_k, cnt, h_cap)
    args[n_f] = ss.force_local_capped_args(
        cfg, ext, g8, cid, rho_e, rho_k, ws, wc, sub_src, cand_cid, w_sub,
        h_cap, p_cap, band)
    acc_k, acc_p = ss.force_ext_capped(*args[n_f]), ss.force_ext_capped_plain(
        *args[n_f])
    _, pos_l, mass_l, cid_l, _, _, cpos, cmass = args[n_d][:8]
    _, _, vel_l, _, cand = args[n_f][:5]
    block = {
        n_d: lambda: sw._launch_density(
            cfg, sw.EXCL_SRC, pos_l, mass_l, cid_l, ws, wc, cpos, cmass,
            cand_cid, sub_src, None, "density_kernel_t<capped>[slab]", h_cap),
        n_f: lambda: sw._launch_force(
            cfg, sw.EXCL_SRC, pos_l, vel_l, rho_k, cand, cid_l, ws, wc,
            cand_cid, sub_src, "force_kernel_t<capped>[slab]", h_cap)}
    (rho_b, nc_b), acc_b = (fn() for fn in block.values())
    torch.cuda.synchronize()
    finite(label, n_d, rho_k, nc_k)
    finite(label, n_f, acc_k)
    nlive = -(-cnt // sw._blane(cfg)) * 9
    window = sublane_rows_per_thread(
        cfg, SimpleNamespace(ws=ws[:nlive], wc=wc[:nlive]), s_len)
    stats = slab_sub_band_rows_per_lane(cfg, band, cnt)
    print(f"[{label}] rows tested per thread (live blocks): block window "
          f"{window:.1f}, band mean {stats['mean']:.1f}, band max over a "
          f"warp {stats['warp_max']:.1f}, warp union "
          f"{stats['warp_union']:.1f}")
    bits = (bool(torch.equal(nc_b, nc_k)), bool(torch.equal(rho_b, rho_k)),
            bool(torch.equal(acc_b, acc_k)))
    dead = not (nc_k[cnt:].any() or rho_k[cnt:].any() or acc_k[cnt:].any())
    print(f"[{label}] band kernels vs EXCL_SRC block walks over the sub "
          f"frame on the same tensors: every own row counts, rho, acc "
          f"bit-equal={bits}; dead rows 0={dead}")
    check(all(bits), f"{label}: band walk vs block walk bit-equal {bits}")
    check(dead, f"{label}: dead rows write 0")
    errs = {n_d: agree(label, n_d, rho_k, rho_p, (nc_k, nc_p)),
            n_f: agree(label, n_f, acc_k, acc_p, bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    # the sums read the own rows (positions, masses or velocities and rho,
    # the table's self cids), the staged sub-frame columns and src rows,
    # each once, and, as elsewhere, not cell_start, the kernels' own index
    reads = {n_d: (pos_l, mass_l, band.cid, cpos, cmass, sub_src),
             n_f: (pos_l, vel_l, rho_k, band.cid, cand, sub_src)}
    return errs, args, {n_d: pairs, n_f: pairs}, reads, block, stats


def slab_fused_vs_twins(cfg, group, frame, caps, label: str):
    """The slab engine's fused pair, the sub-frame pre-pass K1 and K3, band
    walks over the sub frame's table (``SubBand``), against their twins on
    one rank's frame (``slabs.prepare_frame`` with ``capped_fused``, which
    holds the pre-pass tables) and against their block walks on the same
    card tensors: the pre-pass bit-equal on the kept rows, K3 on every own
    row (the dead rows 0 on both).  Every output row of K3, dead ones
    included, and every kept pre-pass row must be finite.  The halo rows'
    pre-pass densities come from the neighbours (``exchange_rho`` on
    ``group``).  Returns the max abs errors, the arguments used (for
    timing), the pairs within h each kernel sums, the tensors each reads
    (for its bound: each row once, not the table) and the block walks'
    launches, all by kernel name."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        prepass_rows)

    p_cap, h_cap, _ = caps
    ext, cid, f = frame.ext, frame.cid_ext, frame
    ws, wc, sub_src, cand_cid, w_sub, _, band, ws_s, wc_s = f.tabs
    n_kept = int((cand_cid >= 0).sum())
    print(f"[{label}] fused: max_wc_sub={wc_s.max().item()}")
    g8 = ext[sub_src.long()]
    names = ("density_band_t<prepass>[slab]", "fused_band_t[slab]")
    args = {names[0]: ss.density_sub_local_args(cfg, g8, sub_src, cand_cid,
                                                w_sub, ws_s, wc_s, band)}
    sub_k = ss.density_sub_pre(*args[names[0]])
    _, pos_sub, mass_sub, wm_sub, cid_sub, src_sub = args[names[0]][:6]
    sub_bk, sub_nk = sw._launch_density_band(
        cfg, pos_sub, mass_sub, cid_sub, band.cell_start, pos_sub, wm_sub,
        src_sub, names[0], self_src=src_sub)
    # density_sub_pre_plain's own call, keeping the counts
    sub_p, sub_nc = sw.density_t_plain(cfg, pos_sub, mass_sub, cid_sub,
                                       ws_s, wc_s, pos_sub, wm_sub,
                                       cid_sub, src_sub, src_sub)
    rho_cand, w_cand = slabs.fused_candidates(slabs.exchange_rho(
        group, slabs.scatter_sub_rho(sub_k, sub_src, cand_cid, h_cap, p_cap),
        f.count, h_cap), sub_src, w_sub)
    args[names[1]] = ss.fused_local_capped_args(
        cfg, ext, g8, cid, rho_cand, ws, wc, sub_src, cand_cid, w_cand, h_cap,
        p_cap, band)
    fused_k = ss.fused_ext(*args[names[1]])
    facc_k, frho_k, fnc_k = fused_k
    facc_p, frho_p, fnc_p = ss.fused_ext_plain(*args[names[1]])
    _, pos_l, vel_l, mass_l, cid_l, _, _, cand = args[names[1]][:8]
    block = {
        names[0]: lambda: sw._launch_density(
            cfg, sw.EXCL_SRC_SRC, pos_sub, mass_sub, cid_sub, ws_s, wc_s,
            pos_sub, wm_sub, cid_sub, src_sub, src_sub,
            "density_kernel_t<prepass>[slab]"),
        names[1]: lambda: sw._launch_fused(
            cfg, pos_l, vel_l, mass_l, cid_l, ws, wc, cand, cand_cid, sub_src,
            "fused_kernel_t[slab]", h_cap)}
    torch.cuda.synchronize()
    finite(label, names[0], sub_k[:n_kept])
    finite(label, names[1], facc_k, frho_k, fnc_k)
    check(bool(torch.equal(sub_bk, sub_k)),
          f"{label}: pre-pass wrapper == its launch")
    fused_vs_block(label, n_kept, (sub_k, sub_nk), block[names[0]](),
                   fused_k, block[names[1]](),
                   prepass_rows(cfg, cid_sub, ws_s, wc_s, band.cell_start))
    cnt = f.count
    dead = not (fnc_k[cnt:].any() or frho_k[cnt:].any()
                or facc_k[cnt:].any())
    check(dead, f"{label}: K3's dead rows write 0")
    errs = {
        # the tail rows' pre-pass values feed no pair: kept rows only
        names[0]: agree(label, f"{names[0]} (kept rows)", sub_k[:n_kept],
                        sub_p[:n_kept], (sub_nk[:n_kept], sub_nc[:n_kept])),
        names[1]: max(agree(label, f"{names[1]} rho", frho_k, frho_p,
                            (fnc_k, fnc_p)),
                      agree(label, f"{names[1]} acc", facc_k, facc_p,
                            bar=ACC_BAR)),
    }
    # each row once and not the table, as for the capped pair: the pre-pass
    # its sub rows (positions, true and reweighted masses, cids, src rows),
    # K3 the own rows (positions, velocities, masses, the table's self
    # cids), the staged sub-frame columns and src rows
    reads = {names[0]: (pos_sub, mass_sub, wm_sub, cid_sub, src_sub),
             names[1]: (pos_l, vel_l, mass_l, band.cid, cand, sub_src)}
    return (errs, args, {names[0]: int(sub_nk[:n_kept].sum()),
                         names[1]: int(fnc_k.sum())}, reads, block)


# the block-walk launchers of ops/sweeps_t.py: density_kernel_t (every
# Excl), force_kernel_t and fused_kernel_t, the band walks' reference only
BLOCK_WALKS = ("_launch_density", "_launch_force", "_launch_fused")


@contextlib.contextmanager
def counting_block_walks():
    """Count every block-walk launch (by launcher) while the context is
    open: no step path may run one."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    counts = dict.fromkeys(BLOCK_WALKS, 0)
    saved = {name: getattr(sw, name) for name in BLOCK_WALKS}

    def counted(name):
        def launch(*a, **kw):
            counts[name] += 1
            return saved[name](*a, **kw)
        return launch

    for name in BLOCK_WALKS:
        setattr(sw, name, counted(name))
    try:
        yield counts
    finally:
        for name, launch in saved.items():
            setattr(sw, name, launch)


def no_block_walk(path: str, counts: dict) -> None:
    print(f"[main {path}] block-walk launches: "
          + ", ".join(f"{k.removeprefix('_launch_')} {v}"
                      for k, v in counts.items()))
    check(not any(counts.values()), f"{path}: no block walk {counts}")
    counts.update(dict.fromkeys(counts, 0))


def walks_in_turns(args: dict, block: dict, label: str,
                   bands: dict | None = None) -> None:
    """Time each band kernel and its block walk (``block``: kernel name ->
    launch) in turns (band, block, block, band) by CUDA events at the given
    arguments (or, where ``bands`` names its launch, by that launch)."""
    for name, launch in block.items():
        fns = {"band walk": (bands or {}).get(
                   name, lambda name=name: wrapper(name)(*args[name])),
               "block walk": launch}
        ms = {w: [] for w in fns}
        for w in [*fns, *reversed(fns)]:
            ms[w].append(time_ms(fns[w], iters=10, warmup=1))
        print(f"[{label}] {name} in turns (CUDA events, ms per launch): "
              + "; ".join(f"{w} {' '.join(f'{t:.4f}' for t in ts)}"
                          for w, ts in ms.items()))


def io_bytes(args: tuple, out) -> int:
    """Bytes a call must move: each input tensor read once (a tensor passed
    twice counts once), each output written once."""
    outs = out if isinstance(out, tuple) else (out,)
    ins = {(a.data_ptr(), a.nbytes) for a in args if isinstance(a, torch.Tensor)}
    return sum(b for _, b in ins) + sum(o.nbytes for o in outs)


def timed(args: dict, pairs: dict, twin_args: dict | None = None,
          reads: dict | None = None, launch: dict | None = None) -> dict:
    """Per kernel at the given arguments: kernel and twin ms (CUDA events)
    and the bound, the larger of its bytes over the HBM rate and its flops
    on the pairs within h over the f32 rate.  ``twin_args`` are the twin's
    arguments where they differ from the kernel's, ``reads`` the tensors
    the kernel reads where not all of its arguments (for the bytes),
    ``launch`` the kernel's launch where it is timed apart from its
    wrapper."""
    out = {}
    for name, a in args.items():
        kern = (launch or {}).get(name, lambda a=a, w=wrapper(name): w(*a))
        twin = getattr(_module(name), KERNELS[name].twin)
        t_a = (twin_args or {}).get(name, a)
        nbytes = io_bytes((reads or {}).get(name, a), kern())
        flops = pairs[name] * KERNELS[name].flops_per_pair
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        out[name] = dict(ms=time_ms(kern, iters=10, warmup=1),
                         plain_ms=time_ms(lambda: twin(*t_a), iters=3,
                                          warmup=1),
                         bound_ms=max(t_bytes, t_ops) * 1e3,
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
    return out


def compare(label: str, a, b, names: str) -> None:
    """Two backends' (acc, rho, aux) on one state: counts equal, rho and acc
    within the bars, no candidate range cut on either side."""
    (acc_a, rho_a, aux_a), (acc_b, rho_b, aux_b) = a, b
    equal = bool(torch.equal(aux_a.neighbor_count, aux_b.neighbor_count))
    r_rho, r_acc = rel_l2(rho_a, rho_b), rel_l2(acc_a, acc_b)
    cut = (int(aux_a.truncated_ranges), int(aux_b.truncated_ranges))
    print(f"[{label}] {names}: counts_equal={equal} mean_neighbors="
          f"{aux_a.neighbor_count.float().mean().item():.3f} "
          f"rho_rel_l2={r_rho:.3e} acc_rel_l2={r_acc:.3e} truncated={cut}")
    check(equal, f"{label}: {names} neighbor counts equal")
    check(r_rho <= RHO_BAR, f"{label}: {names} rho rel-L2 {r_rho}")
    check(r_acc <= ACC_BAR, f"{label}: {names} acc rel-L2 {r_acc}")
    check(cut == (0, 0), f"{label}: {names} truncated ranges {cut}")


def vpu_vs_plain(dev) -> float:
    """Every chain op over the probe's [131072, 128] input at K = 1 and
    K = 4, and the reciprocal table (K = 1 over 8192 values), against the
    plain chain at the op's bar; the ops both sides round in IEEE f32 also
    at the probe's K = 64 (the kernel's unrolled body), bit-equal.  A deep
    rsqrt or center chain reaches its fixed point and an even-deep
    reciprocal chain its start, so the approximate ops are held only at
    the shallow depths.  Returns the max abs error."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_vpu_ops as pv)

    x = pv.make_input(pv.BLOCKS, dev)
    cases = [(op, x, k) for k in (1, 4) for op in pv.OPS]
    cases += [(op, x, pv.K) for op in pv.OPS if pv.BARS[op] == 0]
    cases.append(("recip_approx", pv.recip_table(dev), 1))
    worst = 0.0
    for op, inp, k in cases:
        a, b = pv.chain(inp, op, k), pv.chain_plain(inp, op, k)
        torch.cuda.synchronize()
        equal = bool(torch.equal(a, b))
        rel = ((a.double() - b.double()).abs() / b.double().abs()).max().item()
        bar = pv.BARS[op]
        print(f"[probe vpu] chain_kernel<{op}> K={k} over {tuple(inp.shape)} "
              f"vs plain: bit-equal={equal} max rel={rel:.3e} (bar: "
              + ("bit-equal" if bar == 0 else f"rel <= {bar:g}") + ")")
        check(equal if bar == 0 else rel <= bar,
              f"chain_kernel<{op}> K={k} vs plain: rel {rel}")
        worst = max(worst, max_abs(a, b))
    return worst


# gather_smem's CTAs in the walk check: far fewer than the tiles at every S
# and no divisor of any S's tile count, so each CTA wraps its ring many times
# and the last round is partial
WALK_GRID = 7


def gather_vs_plain(dev) -> float:
    """Every gather-probe mode and ``ONESHOT`` (the first design of
    ``gather_smem``, its reference in turns), the gathers with lane-varying
    and lane-uniform indices, at each S of the JAX probe, bit-equal to the
    plain version; ``gather_smem`` also on ``WALK_GRID`` CTAs.  Returns
    the max abs error."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather as pg)

    worst = 0.0
    for S in pg.SIZES:
        src, idx_v, idx_u = pg.make_inputs(S, pg.ELEMENTS, dev)
        ring = pg.pipeline(S)
        tiles = src.shape[0] // S * (pg.LANES // ring["w"])
        check(tiles % WALK_GRID != 0 and tiles > 2 * ring["stages"]
              * WALK_GRID, f"S={S}: {tiles} tiles walk unevenly round the "
              f"ring on {WALK_GRID} CTAs")
        cases = [(m, idx_v, 0) for m in pg.KERNEL_MODES] + [
            (m, idx_u, 0) for m in pg.KERNEL_MODES if m.startswith("gather")]
        cases += [("gather_smem", idx, WALK_GRID) for idx in (idx_v, idx_u)]
        for mode, idx, grid in cases:
            a = pg.gather_tile(src, idx, S, mode, grid=grid)
            b = pg.gather_tile_plain(src, idx, S, mode)
            torch.cuda.synchronize()
            check(bool(torch.equal(a, b)),
                  f"gather_tile_kernel<{mode}> S={S} grid={grid} bit-equal "
                  "to plain")
            worst = max(worst, max_abs(a, b))
        print(f"[probe gather] S={S} nb={src.shape[0] // S} pipeline {ring}, "
              f"one-shot w={pg.oneshot_width(S)}: {len(cases)} cases "
              f"({', '.join(pg.KERNEL_MODES)}; gathers lane-varying and "
              f"lane-uniform; gather_smem also on {WALK_GRID} CTAs, "
              f"{tiles} tiles, up to {-(-tiles // WALK_GRID)} a CTA) "
              "bit-equal to plain")
    return worst


def gather_in_turns(dev) -> None:
    """``gather_smem`` (the persistent TMA pipeline) against ``ONESHOT``
    (its first design) in turns (old, new, new, old; queued CUDA events,
    20 runs after 3, on ``probe_gather.rotation``'s copies of the inputs)
    at every S, lane-varying and lane-uniform indices."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather as pg)

    for S in pg.SIZES:
        src, idx_v, idx_u = pg.make_inputs(S, pg.ELEMENTS, dev)
        bound = 3 * src.nbytes / HBM_BYTES_PER_S * 1e3
        for kind, idx in (("lane-varying", idx_v), ("lane-uniform", idx_u)):
            fns = {"old": pg.rotation(
                       lambda s, i: pg.gather_tile(s, i, S, pg.ONESHOT), src,
                       idx),
                   "new": pg.rotation(
                       lambda s, i: pg.gather_tile(s, i, S, "gather_smem"),
                       src, idx)}
            ms = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                ms[which].append(time_ms(fns[which]))
            print(f"[probe gather] S={S} {kind} in turns (ms): one-shot "
                  f"{ms['old'][0]:.5f} {ms['old'][1]:.5f}, pipeline "
                  f"{ms['new'][0]:.5f} {ms['new'][1]:.5f}; bound "
                  f"{bound * 1e3:.2f} us (bytes), pipeline at "
                  f"{bound / min(ms['new']):.0%} of it")


def queued_timer(dev) -> None:
    """The one-shot gather (S = 1024, lane-varying), ``torch.gather`` on the
    same function and ``chain_kernel<center_now>`` (K = 64) under the
    queued timer, twice each: the card's sleep before the start event must
    outlast the host's enqueue of the 20 timed calls."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather as pg, probe_vpu_ops as pv, timing)

    S = 1024
    src, idx_v, _ = pg.make_inputs(S, pg.ELEMENTS, dev)
    x = pv.make_input(pv.BLOCKS, dev)
    fns = {"one-shot gather S=1024": pg.rotation(
               lambda s, i: pg.gather_tile(s, i, S, pg.ONESHOT), src, idx_v),
           "torch.gather S=1024": pg.rotation(
               lambda s, i: torch.gather(s, 1, i),
               src.view(-1, S, pg.LANES), idx_v.view(-1, S, pg.LANES).long()),
           "chain_kernel<center_now> K=64": lambda: pv.chain(x, "center_now",
                                                             pv.K)}
    for name, fn in fns.items():
        runs = [timing(fn) for _ in range(2)]
        check(all(r["covered"] for r in runs),
              f"{name}: the sleep outlasts the enqueue")
        print(f"[timer] {name} (ms a call; 20 runs after 3, queued): "
              + " ".join(f"{r['ms']:.5f}" for r in runs)
              + "; host enqueue of 20 calls " + " ".join(
                  f"{r['enqueue_ms']:.3f}" for r in runs)
              + " ms, card sleep " + " ".join(
                  f"{r['sleep_ms']:.3f}" for r in runs) + " ms")


def mxu_vs_plain(dev) -> float:
    """Each d^2 mode at the JAX probe's shapes (one tile, off 40) and over
    4096 tiles, against its plain version (<= 1e-4 max abs), FMA and 3xTF32
    also against the f32 plain version.  Returns the max abs error against
    each mode's own plain version."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import probe_mxu as pm

    worst = 0.0
    for tiles, off in ((1, 40), (pm.TILES, None)):
        g, selfv, offs = pm.make_tiles(tiles, dev, off=off)
        f32 = pm.d2_tile_plain(g, selfv, offs, "fma")
        for mode in pm.MODES:
            a = pm.d2_tile(g, selfv, offs, mode)
            own = max_abs(a, pm.d2_tile_plain(g, selfv, offs, mode))
            vs_f32 = max_abs(a, f32)
            print(f"[probe mxu] d2_tile_kernel<{mode}> {tiles} tile(s): max "
                  f"abs vs its plain {own:.3e}, vs f32 plain {vs_f32:.3e} "
                  f"(bar {pm.BAR:g}" + (" vs f32 too)" if mode != "tf32"
                                        else ")"))
            check(own <= pm.BAR, f"d2_tile_kernel<{mode}> vs plain {own}")
            check(mode == "tf32" or vs_f32 <= pm.BAR,
                  f"d2_tile_kernel<{mode}> vs f32 plain {vs_f32}")
            worst = max(worst, own)
    return worst


def sass_checks(mix: dict, body: dict) -> None:
    """The chain kernels compiled as the probe assumes: sqrtf and '/' as
    IEEE sequences (a MUFU seed refined by FFMAs; the divide's FCHK range
    check), not as one MUFU approximation; the mul chain not folded (16
    multiplies in its unrolled body at least); every op that issues on the
    MUFU at least one unrolled body's worth of its MUFU instructions; and
    each op's counted unrolled body (``sass_body_mix``, which the bounds
    are counted from) at least its floor ``MIX`` of f32 and MUFU
    instructions a step."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_vpu_ops as pv)

    check("MUFU.SQRT" not in mix["sqrt"] and mix["sqrt"]["FFMA"] > 0,
          f"sqrtf is an IEEE sequence: {dict(mix['sqrt'])}")
    check(mix["div"]["FCHK"] > 0 and mix["div"]["FFMA"] > 0,
          f"'/' is an IEEE divide: {dict(mix['div'])}")
    check(mix["mul"]["FMUL"] >= 16, f"mul chain unfolded: {dict(mix['mul'])}")
    folded = pv.sass_folded(mix)
    check(not folded, f"MUFU chains unfolded: {folded}")
    for op, (fp32, mufu) in pv.MIX.items():
        step = pv.step_mix(body[op])
        check(step["fp32"] >= fp32 and step["mufu"] >= mufu,
              f"chain_kernel<{op}> counted body {dict(body[op])} holds its "
              f"floor of {fp32} f32 and {mufu} MUFU a step")


def chain_ranges(dev) -> None:
    """The chains whose IEEE sequences branch to a slow path (sqrtf, '/',
    __frcp_rn, the center term): every value each step of the plain chain
    takes from the probe's input (1.3 + U[0, 1) 0.5, K = 64) lies in
    [2^-20, 2^20], far inside the range the fast paths take, so the counted
    bodies (which leave the slow paths out) are what the kernels issue."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_vpu_ops as pv)

    x = pv.make_input(pv.BLOCKS, dev)
    for op in ("sqrt", "div", "recip", "center_now"):
        v, lo, hi = x, float("inf"), 0.0
        for _ in range(pv.K):
            v = pv.chain_plain(v, op, 1)
            lo = min(lo, v.abs().min().item())
            hi = max(hi, v.abs().max().item())
        print(f"[probe vpu] chain_kernel<{op}> K={pv.K}: every step's values "
              f"in [{lo:.4g}, {hi:.4g}] (the fast paths')")
        check(2.0**-20 <= lo and hi <= 2.0**20,
              f"chain_kernel<{op}> values stay normal: [{lo}, {hi}]")


def probe_records(dev, vpu: dict, gat: dict, mxu: dict) -> dict:
    """Each probe kernel's record for the kernels line, at one case of its
    probe's main run (its time, bound and case from there): the plain
    version's time and, where one PyTorch call computes the same function,
    that call's time, on the same inputs."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather as pg, probe_mxu as pm, probe_vpu_ops as pv)

    out = {}
    x = pv.make_input(pv.BLOCKS, dev)
    row = vpu["ops"]["center_now"]
    out["chain_kernel"] = dict(
        case=f"center_now (K2's sqrtf + divide), K={pv.K}, {tuple(x.shape)}",
        ms=row["ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        bound_class=f"{row['bound_class']}, counted from the unrolled body: "
                    f"{row['step']['work']:.3f} instructions of work a step "
                    f"(control, {row['step']['control']:.3f}, left out)",
        plain_ms=time_ms(lambda: pv.chain_plain(x, "center_now", pv.K),
                         iters=3, warmup=1),
        library_ms=None)
    S = 1024
    src, idx_v, _ = pg.make_inputs(S, pg.ELEMENTS, dev)
    row = next(r for r in gat["tiles"] if r["S"] == S)
    out["gather_tile_kernel"] = dict(
        case=f"gather_smem (persistent TMA pipeline), lane-varying indices, "
             f"S={S}, {tuple(src.shape)}, {pg.COPIES} rotating copies",
        ms=row["gather_smem"], bound_ms=row["gather_bound_ms"],
        bound_by="bytes",
        plain_ms=time_ms(pg.rotation(
            lambda s, i: pg.gather_tile_plain(s, i, S, "gather_smem"), src,
            idx_v), iters=10, warmup=1),
        library_ms=time_ms(pg.rotation(
            lambda s, i: torch.gather(s, 1, i), src.view(-1, S, pg.LANES),
            idx_v.view(-1, S, pg.LANES).long()), iters=10, warmup=1))
    g, selfv, offs = pm.make_tiles(mxu["tiles"], dev)
    row = mxu["timed"]["tf32x3"]
    out["d2_tile_kernel"] = dict(
        case=f"tf32x3 (the analog of HIGHEST), {mxu['tiles']} tiles",
        ms=row["ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
        plain_ms=time_ms(
            lambda: pm.d2_tile_plain(g, selfv, offs, "tf32x3"), iters=10,
            warmup=1),
        library_ms=mxu["library_ms"])
    return out


# phase 16: the CLI in this process, as a user runs it.  The reference's
# headless run (the 32k disk, cfg.num_steps + 1 = 1001 steps in blocks of
# 50) checkpointed every 500 steps; its resumes; the 1M splash's 20 steps
# with their outputs; info, watch and a small sweep
CLI_STEPS = 1001
CLI_EVERY = 500
CLI_APPLY = (700, "viscosity", 0.02)
CLI_SPLASH = ["--scene", "splash", "--steps", "20", "--block", "10"]
CLI_SWEEP = ["--scene", "honey", "--steps", "50", "--block", "25",
             "--viscosity", "0.01,10", "--stiffness", "1e-4"]
CLI_FILES = {"energy.txt": "Step, Kinetic Energy, Potential Energy, "
             "Total Energy", "angularmomentum.txt": "Step, Angular Momentum",
             "timing.txt": "Step, Voxelize, Find Neighbors, Compute Density, "
             "Compute Pressure, Compute Acceleration, Integrate",
             "neighbors.txt": None, "diagnostics.jsonl": None}


def cli(argv: list[str]) -> tuple[int, str]:
    """The port's CLI in this process, so the launch counters see its
    kernels: its exit code and standard output."""
    from smoothed_particle_hydrodynamics_tpu_torch.__main__ import main as run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run(argv)
    return rc, buf.getvalue()


def _lines(path: str) -> list[str]:
    with open(path) as fh:
        return fh.read().splitlines()


def _jsonl(path: str) -> list[dict]:
    return [json.loads(x) for x in _lines(path)]


def _finite_state(st) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in st)


def cli_phase(dev) -> None:
    """Phase 16: ``run``, its checkpoints and resumes, ``info``, ``watch``
    and ``sweep`` through the port's ``__main__.main`` on the card."""
    from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
    from smoothed_particle_hydrodynamics_tpu_torch.init import load_state
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops.lazy import (
        drive_loop_lazy)
    from smoothed_particle_hydrodynamics_tpu_torch.utils import io as ckpt_io
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        run_benchmark)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.diagnostics import (
        DiagnosticsWriter, host_diagnostics)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.native import (
        AsyncFileWriter)

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        # the reference's headless run, counted
        d1, ck = f"{root}/disk", f"{root}/ck"
        reset_launches()
        with counting_block_walks() as block_walks:
            w0 = time.perf_counter()
            rc, _ = cli(["run", "--out", d1, "--checkpoint-every",
                         str(CLI_EVERY), "--checkpoint-dir", ck, "--quiet"])
            wall = time.perf_counter() - w0
        counts = {name: wrapper(name).launches
                  for name in ("density_band_t", "force_band_t")}
        check(rc == 0, f"cli disk run exit {rc}")
        meta = json.load(open(f"{d1}/run.json"))
        cfg = SphConfig.from_json(json.dumps(meta["config"]))
        rows = _jsonl(f"{d1}/diagnostics.jsonl")
        print(f"[cli disk] run: {CLI_STEPS} steps of the {cfg.num_particles}"
              f" disk ({meta['backend']}, lazy {meta['lazy']}, "
              f"{meta['device']}) in {wall:.3f} s with its outputs; median "
              f"{statistics.median(r['step_ms'] for r in rows):.4f} ms/step "
              f"(diagnostics.jsonl); launches {counts}")
        no_block_walk("cli disk", block_walks)
        for name, c in counts.items():
            check(c >= CLI_STEPS, f"cli disk: {name} launched {c} times")
        check(cfg.num_steps + 1 == CLI_STEPS and meta["lazy"]
              and meta["backend"] == "pallas", f"cli disk: {meta}")
        for name, header in CLI_FILES.items():
            lines = _lines(f"{d1}/{name}")
            body = lines if header is None else lines[1:]
            check(header is None or lines[0] == header,
                  f"cli disk: {name} header {lines[:1]}")
            check(len(body) == CLI_STEPS, f"cli disk: {name} has "
                  f"{len(body)} rows")
        energy = [[float(x) for x in ln.split(", ")]
                  for ln in _lines(f"{d1}/energy.txt")[1:]]
        check([int(e[0]) for e in energy] == list(range(CLI_STEPS))
              and all(math.isfinite(x) for e in energy for x in e),
              "cli disk: energy.txt steps 0..1000, energies finite")
        check(all(r["truncated_ranges"] == 0 for r in rows),
              "cli disk: truncated_ranges 0 in every row")
        check(meta["fingerprint"] == ckpt_io.config_fingerprint(cfg),
              "cli disk: run.json fingerprint")
        final = load_state(f"{d1}/final_state.npz", dev)
        check(final.n == cfg.num_particles and _finite_state(final),
              "cli disk: final_state.npz loads, finite")
        for step in (CLI_EVERY, 2 * CLI_EVERY):
            s, c, st = ckpt_io.load_checkpoint(
                f"{ck}/ckpt_{step:08d}.npz", dev)
            check(s == step and c == cfg and st.n == cfg.num_particles
                  and _finite_state(st), f"cli disk: checkpoint {step}")
        s, c, back = ckpt_io.load_checkpoint(ckpt_io.save_checkpoint(
            f"{root}/round", CLI_STEPS, cfg, final), dev)
        check(s == CLI_STEPS and c == cfg and all(
            torch.equal(a, b) for a, b in zip(back, final)),
            "cli disk: checkpoint round trip bit-equal on the card")
        print(f"[cli disk] 5 files x {CLI_STEPS} rows, run.json fingerprint "
              f"{meta['fingerprint']}, checkpoints {sorted(os.listdir(ck))},"
              f" final total energy {rows[-1]['total_energy']:.9e}; "
              "checkpoint round trip bit-equal")

        # resume at 1000, then from 500 with an apply at 700
        d2 = f"{root}/resumed"
        rc, _ = cli(["run", "--resume", "--checkpoint-dir", ck, "--out", d2,
                     "--quiet"])
        first = _lines(f"{d2}/energy.txt")[1]
        check(rc == 0 and first.startswith(f"{2 * CLI_EVERY}, "),
              f"cli resume: exit {rc}, first row {first!r}")
        ck500 = f"{root}/ck500"
        os.makedirs(ck500)
        shutil.copy(f"{ck}/ckpt_{CLI_EVERY:08d}.npz", ck500)
        d3 = f"{root}/applied"
        at, key, value = CLI_APPLY
        rc, text = cli(["run", "--resume", "--checkpoint-dir", ck500,
                        "--out", d3, "--apply", f"{at}:{key}={value}",
                        "--quiet"])
        rows3 = _jsonl(f"{d3}/diagnostics.jsonl")
        applied = f"applied at step {at}: {key}={value}"
        check(rc == 0 and applied in text, f"cli apply: exit {rc}, {text!r}")
        check([r["step"] for r in rows3] == list(range(CLI_EVERY, CLI_STEPS)),
              "cli apply: rows 500..1000")
        e1, e3 = rows[-1]["total_energy"], rows3[-1]["total_energy"]
        print(f"[cli resume] from {2 * CLI_EVERY}: first row {first!r}; from "
              f"{CLI_EVERY} with --apply {at}:{key}={value} (disk "
              f"{cfg.viscosity}): {applied!r} printed, rows "
              f"{rows3[0]['step']}..{rows3[-1]['step']}, final total energy "
              f"{e3:.9e}, relative to the straight run's {e1:.9e}: "
              f"{(e3 - e1) / abs(e1):+.6e}")

        # the main path's step with its outputs, beside run_benchmark's
        d4 = f"{root}/splash"
        w0 = time.perf_counter()
        rc, _ = cli(["run", *CLI_SPLASH, "--out", d4, "--quiet"])
        wall = time.perf_counter() - w0
        check(rc == 0, f"cli splash run exit {rc}")
        rows4 = _jsonl(f"{d4}/diagnostics.jsonl")
        blocks = list(dict.fromkeys(r["step_ms"] for r in rows4))
        check(len(rows4) == 20 and all(math.isfinite(r["total_energy"])
                                       for r in rows4), "cli splash rows")
        # the same config: 3 warmup + 20 timed steps, and the CLI's second
        # block alone (10 warmup + 10 timed steps)
        r, r2 = (run_benchmark(scene="splash", lazy=None, steps=k, warmup=w,
                               device="cuda", backend="pallas")
                 for k, w in ((20, 3), (10, 10)))
        writer = AsyncFileWriter()
        native = writer.stats()["native"]
        writer.close()
        cfg_d, st_d = make_scene("disk", device=dev)
        _, d = drive_loop_lazy(cfg_d, st_d, 10)
        reps = 50
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(reps):
            host_diagnostics(d)
        fetch_ms = (time.perf_counter() - w0) * 1e3 / reps
        with DiagnosticsWriter(f"{root}/fetch") as w:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            for i in range(reps):
                w.write_block(10 * i, d, {"step": 1.0})
            write_ms = (time.perf_counter() - w0) * 1e3 / reps
        med = statistics.median(x["step_ms"] for x in rows4)
        print(f"[cli splash] run {' '.join(CLI_SPLASH)} (1M, lazy, exact): "
              f"{wall:.2f} s; ms/step per block from diagnostics.jsonl "
              f"{blocks}, median {med:.4f}; run_benchmark on the same "
              f"config: {r['ms_per_step']:.4f} ms/step (3 warmup + 20 "
              f"steps), {r2['ms_per_step']:.4f} ms/step (10 warmup + 10 "
              f"steps, the second block's); writer native={native}; "
              f"per-block host fetch of a 10-step block (host_diagnostics: "
              f"two stacks, two copies) {fetch_ms:.4f} ms, write_block "
              f"{write_ms:.4f} ms")
        del st_d, d

        # info, watch, a small sweep
        rc, text = cli(["info"])
        check(rc == 0 and json.loads(text)["num_particles"] == 32768,
              f"cli info: exit {rc}")
        rc, text = cli(["watch", "--once", "--out", d1])
        check(rc == 0 and "E_total" in text, f"cli watch: exit {rc}")
        sweep = f"{root}/sweep.json"
        rc, _ = cli(["sweep", *CLI_SWEEP, "--out", sweep])
        recs = json.load(open(sweep))
        by_mu = {x["viscosity"]: x for x in recs}
        check(rc == 0 and len(recs) == 2 and by_mu[10.0]["stable"],
              f"cli sweep: exit {rc}, {recs}")
        print(f"[cli] info, watch --once and sweep exit 0; watch: "
              f"{text.splitlines()[1]!r}; sweep: {json.dumps(recs)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[cli] phase 16 took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops import pairwise
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.ops.grid import (
        cell_coords, linear_cell_id)
    from smoothed_particle_hydrodynamics_tpu_torch.ops.integrate import (
        energy_tally)
    from smoothed_particle_hydrodynamics_tpu_torch.ops.lazy import (
        drive_loop_lazy)
    from smoothed_particle_hydrodynamics_tpu_torch.ops.step import (
        compute_forces)
    from smoothed_particle_hydrodynamics_tpu_torch.utils import build
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs
    from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import (
        local_group, spawn_ranks)
    from smoothed_particle_hydrodynamics_tpu_torch.state import state_to_numpy
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_scene, resolve_sweep_settings, run_benchmark,
        run_parity_check, run_slab_benchmark, slab_setup)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        band_rows_per_lane, corner_state)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
          f" torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build from the checkout's sources, one nvcc per source in parallel
    t0 = time.perf_counter()
    build.build_libraries(["sweep_t", "sweep_lane", "probes"])
    print(f"[build] sweep_t.cu + sweep_lane.cu + probes.cu built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("sweep_t", "sweep_lane", "probes"):
        build.load_library(name)
        print(build.build_log(name).strip())

    def oracle(label, cfg, st):
        """Step quantities against the pairwise oracle (hydro only)."""
        acc, rho, aux = sw.compute_step_quantities(cfg, st)
        nc, trunc = aux.neighbor_count, aux.truncated_ranges
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

    # 2. exact kernels vs twins and vs the block walk, 32k splash (packed
    #    pool: 32^3 grid of 1.25h cells; 64-row windows so multi-chunk block
    #    walks are exercised)
    cfg, st = make_scene("splash", device=dev, num_particles=32768, **small)
    exact_vs_twins(cfg, sw.prepare_t(cfg, st), "exact 32k")

    # 3. exact kernels vs the pairwise oracle, n = 4096
    cfg, st = make_scene("splash", device=dev, **oracle_kw)
    oracle("exact 4096", cfg, st)

    # 4. the exact main path's shapes: agreement and times, the band kernels
    #    vs the block walk (in turns) and vs their twins
    cfg, st = make_scene("splash", device=dev, **MAIN)
    errs, (args, twin_args, reads), pairs, block = exact_vs_twins(
        cfg, sw.prepare_t(cfg, st), "exact 1M")
    times = timed(args, pairs, twin_args, reads)
    walks_in_turns(args, block, "exact 1M")
    del args, twin_args, reads, block

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
    capped_errs, (args, twin_args, reads), capped_pairs, block = \
        capped_vs_twins(cfg, p, "capped 1M")
    errs.update(capped_errs)
    pairs.update(capped_pairs)
    times.update(timed(args, capped_pairs, twin_args, reads))
    walks_in_turns(args, block, "capped 1M")
    exact = cfg.replace(capped_candidates=0)
    rho_e = sw.density_sweep_t(exact, sw.prepare_t(exact, st))[0]
    rho_c = sw.density_sweep_t(cfg.replace(capped_fused=False), p)[0]
    ratio = rho_c.double().mean().item() / rho_e.double().mean().item()
    print(f"[capped 1M] capped rho mean / exact rho mean on the same state: "
          f"{ratio:.6f}")
    check(0.99 < ratio < 1.01, f"capped density unbiased: ratio {ratio}")
    del p, args, twin_args, reads, block, st, rho_e, rho_c

    # 8. lane band kernels vs twins and vs the block walk: a 32k packed
    #    splash with 128-row windows (multi-chunk walks), a frame whose
    #    windows the 127-chunk clamp cuts, then the lane main path's 1M
    #    shapes, timed, and band and block walks in turns
    cfg, st = make_scene("splash", device=dev, num_particles=32768,
                         grid_nx=32, grid_ny=32, grid_nz=32,
                         pallas_layout="lane", pallas_window=128)
    lane_vs_twins(cfg, st, "lane 32k")
    cfg, st = clamped_lane_state(dev)
    cut = lane_vs_twins(cfg, st, "lane clamped", twins=False)
    check(cut > 0, f"lane clamped: the 127 clamp cut chunks ({cut})")
    cfg, st = make_scene("splash", device=dev, **LANE)
    lane_errs, (args, twin_args, reads), lane_pairs, block = lane_vs_twins(
        cfg, st, "lane 1M")
    errs.update(lane_errs)
    pairs.update(lane_pairs)
    times.update(timed(args, lane_pairs, twin_args, reads))
    walks_in_turns(args, block, "lane 1M")
    del args, twin_args, reads, block, st
    for name, t in times.items():
        print(f"[1M] {name}: kernel {t['ms']:.4f} ms, plain twin "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']}: {t['bytes']} bytes, {t['flops']} flops on "
              f"{pairs[name]} pairs)")

    # 9. backend parity on the card: the bench parity check (sublane kernels
    #    vs cell-list sweeps, 32k disk), then lane vs cell-list and lane vs
    #    sublane on the same states of the 32k disk and the 100k dam break
    r = run_parity_check(n=32768, scene="disk", device="cuda")
    print(f"[parity] {json.dumps(r)}")
    check(r["pass"] and r["rho_rel_l2"] <= RHO_BAR
          and r["acc_rel_l2"] <= ACC_BAR, f"parity check {r}")
    for scene in ("disk", "dam_break"):
        cfg, st = make_scene(scene, device=dev)
        label = f"{scene} {st.n}"
        cl = compute_forces(cfg, st, backend="celllist")
        sub = compute_forces(cfg, st, backend="pallas")
        lane = compute_forces(cfg.replace(pallas_layout="lane"), st,
                              backend="pallas")
        compare(label, lane, cl, "lane vs celllist")
        compare(label, lane, sub, "lane vs sublane")
        print(f"[{label}] overflow_cells celllist={int(cl[2].overflow_cells)}"
              f" lane={int(lane[2].overflow_cells)}")
    del cl, sub, lane, st

    # 10. the main paths, counted (the block walks too: no path runs them)
    launches = {}
    for path, (ov, names) in PATHS.items():
        lazy = path != "lane"
        reset_launches()
        with counting_block_walks() as block_walks:
            r = run_benchmark(scene="splash", lazy=lazy, steps=STEPS,
                              warmup=WARMUP, overrides=ov, device="cuda",
                              backend="pallas")
        no_block_walk(path, block_walks)
        counts = {name: wrapper(name).launches for name in KERNELS}
        total_steps = r["warmup_steps"] + r["steps"]
        print(f"[main {path}] 1M splash {'lazy' if lazy else 'eager'} "
              f"{r['pallas_layout']}: {r['ms_per_step']:.4f} ms/step, "
              f"{r['value']:.6e} particle-steps/s over {r['steps']} steps "
              f"(warmup {r['warmup_steps']} steps, {r['warmup_s']:.2f} s); "
              + (f"window {r['window']} block_rows {r['block_rows']}; "
                 if r["pallas_layout"] == "lane" else
                 f"window_t {r['window_t']} block_t {r['block_t']} sub_len "
                 f"{r['capped_sub_len']}; ")
              + f"rebins in timed steps {r['rebins']}; "
              f"launches {counts} for {total_steps} steps; max truncated "
              f"{max(r['truncated_ranges'])}; max overflow_cells "
              f"{max(r['overflow_cells'])}; neighbor mean "
              f"{r['neighbor_mean'][-1]:.4f}; KE {r['kinetic_energy'][0]:.6e} "
              f"-> {r['kinetic_energy'][-1]:.6e}; finite={r['finite']}")
        for name in names:
            check(counts[name] == total_steps, f"{path}: {name} launched "
                  f"{counts[name]} times in {total_steps} steps")
            launches.setdefault(name, counts[name])
        check(len(r["truncated_ranges"]) == total_steps
              and max(r["truncated_ranges"]) == 0,
              f"{path}: truncated_ranges {r['truncated_ranges']}")
        check(r["finite"], f"{path}: positions, velocities and KE finite")
        if path == "capped":
            # the capped path's densities stay unbiased: one lazy step from
            # the benchmark's state, capped and exact
            cfg, st = resolve_scene("splash", dev, ov)
            means = [drive_loop_lazy(c, st, 1)[0].density.double().mean()
                     .item() for c in (cfg, cfg.replace(capped_candidates=0))]
            ratio = means[0] / means[1]
            print(f"[main capped] one lazy step, capped rho mean / exact rho "
                  f"mean: {ratio:.6f}")
            check(0.99 < ratio < 1.01, f"capped path unbiased: {ratio}")
            del st

    # the 32k disk under the lazy sublane driver: central gravity and the
    # gravity-only closing kick
    cfg, st = make_scene("disk", device=dev)
    t0 = energy_tally(cfg, st.position, st.velocity, st.mass)
    reset_launches()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    final, d = drive_loop_lazy(cfg, st, DISK_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    counts = {name: wrapper(name).launches
              for name in ("density_band_t", "force_band_t")}
    finite = bool(torch.isfinite(final.position).all()
                  and torch.isfinite(final.velocity).all()
                  and torch.isfinite(d.kinetic_energy).all())
    print(f"[disk {st.n}] lazy sublane {DISK_STEPS} steps in {wall:.3f} s: "
          f"KE {t0.kinetic.item():.6e} -> {d.kinetic_energy[-1].item():.6e}, "
          f"PE {t0.potential.item():.6e} -> "
          f"{d.potential_energy[-1].item():.6e}, |L| "
          f"{t0.angular_momentum.item():.6e} -> "
          f"{d.angular_momentum[-1].item():.6e}; neighbor mean "
          f"{d.neighbor_mean[-1].item():.4f}; launches {counts}; max "
          f"truncated {int(d.truncated_ranges.max())}; finite={finite}")
    for name, c in counts.items():
        check(c == DISK_STEPS, f"disk: {name} launched {c} times in "
              f"{DISK_STEPS} steps")
    check(int(d.truncated_ranges.max()) == 0, "disk: no candidates dropped")
    check(finite, "disk: positions, velocities and KE finite")

    # 11. the slab callers' kernels vs their twins at the 1M slab shapes
    #     (world size 1: both halos are inert chain ends here); the exact
    #     band walks also vs the EXCL_ROW block walks over the raw frame,
    #     bit-equal on the live rows, the capped ones vs the EXCL_SRC block
    #     walks over the sub frame, bit-equal on every own row, both timed
    #     in turns, with rows per lane equal to the single-chip band walks'
    #     on the same state
    for label, ov in (("slab exact 1M", SLAB), ("slab capped 1M", SLAB_FUSED)):
        cfg, st, zsplit, caps, sub_len = slab_setup(
            1_000_000, ov, SLAB_HEADROOM, dev)
        sub_len = slabs.frame_sub_len(cfg, "pallas", caps[0], caps[1],
                                      sub_len)
        with local_group(dev) as grp:
            carry = slabs.init_lazy_slab(
                cfg, grp, slabs.distribute(cfg, st, grp, caps[0], zsplit),
                caps[0], "pallas", sub_len)
            frame = slabs.prepare_frame(cfg, grp, *caps, "pallas", zsplit,
                                        True, sub_len, carry)
            if cfg.capped_candidates:
                slab_errs, args, slab_pairs, reads, block, stats = \
                    slab_capped_vs_block(cfg, grp, frame, caps, label)
                times.update(timed(args, slab_pairs, reads=reads))
                walks_in_turns(args, block, label)
                # the sub frame keeps each cell's single-chip count
                p1 = sw.prepare_t(cfg, st)
                same_table = bool(torch.equal(frame.tabs[6].cell_start,
                                              p1.cell_start))
                del args, reads, block
                fused_errs, args, fused_pairs, reads, block = \
                    slab_fused_vs_twins(cfg, grp, frame, caps, label)
                slab_errs.update(fused_errs)
                slab_pairs.update(fused_pairs)
                times.update(timed(args, fused_pairs, reads=reads))
                walks_in_turns(args, block, label)
                del reads, block
            else:
                slab_errs, args, slab_pairs, bands, block, stats = \
                    slab_exact_vs_block(cfg, grp, frame, caps, label)
                times.update(timed(args, slab_pairs, reads=bands[1],
                                   launch=bands[0]))
                walks_in_turns(args, block, label, bands[0])
                p1 = sw.prepare_t(cfg, st)
                same_table = True
                del block, bands
            single = band_rows_per_lane(cfg, p1.cid, p1.cell_start, st.n)
            print(f"[{label}] single-chip band walks on the same state: "
                  f"mean {single['mean']:.1f}, max over a warp "
                  f"{single['warp_max']:.1f}, warp union "
                  f"{single['warp_union']:.1f}; slab equal="
                  f"{stats == single}" + (f", cell_start equal={same_table}"
                                          if cfg.capped_candidates else ""))
            check(stats == single and same_table, f"{label}: rows per lane "
                  f"{stats} == single-chip {single}, table equal "
                  f"{same_table}")
            del p1
            errs.update(slab_errs)
            pairs.update(slab_pairs)
        del carry, frame, args, st
    # a frame where the trap of a table over the raw frame shows: the 4
    # ranks of the engine (gloo, all on this card) on a box whose rank-1
    # corner cells are populated and whose ranks 0 and 2 hold fewer rows
    # than h_cap; every rank held bit-equal
    cfg, _ = make_scene("dam_break", device="cpu", num_particles=4096,
                        grid_nx=32, grid_ny=32, grid_nz=32,
                        pallas_window_t=128)
    st = corner_state(cfg, (1_500, 2_500, 30_000), short=300)
    cfg = cfg.replace(num_particles=st.n)
    zsplit = slabs.uniform_zsplit(cfg, 4)
    cfg_c = cfg.replace(**CORNER_CAPPED)
    caps_c = slabs.derive_slab_caps(cfg_c, st, 4, zsplit=zsplit)
    job = dict(cfg=cfg, state=state_to_numpy(st), caps=slabs.derive_slab_caps(
        cfg, st, 4, zsplit=zsplit), zsplit=zsplit, capped=dict(
            cfg=cfg_c, caps=caps_c, sub_len=slabs.frame_sub_len(
                cfg_c, "pallas", caps_c[0], caps_c[1],
                slabs.derive_sub_len_slab(cfg_c, st, 4, zsplit))))
    ranks = spawn_ranks(4, corner_rank, job, backend="gloo",
                        devices=["cuda:0"] * 4, timeout_s=300.0)
    r1, h_cap = ranks[1], job["caps"][1]
    print(f"[slab corner rank 1] {r1['top']} rows in the slab's last cell; "
          f"live halo rows ({r1['nl']}, {r1['nr']}) of h_cap {h_cap}; a "
          f"table over the raw frame would test: band mean "
          f"{r1['raw']['mean']:.1f}, max over a warp "
          f"{r1['raw']['warp_max']:.1f}, warp union "
          f"{r1['raw']['warp_union']:.1f} rows per lane (live table: "
          f"{r1['stats']['warp_max']:.1f} max over a warp)")
    check(r1["top"] > 0 and 0 < r1["nl"] < h_cap and 0 < r1["nr"] < h_cap,
          f"slab corner rank 1: populated last cell ({r1['top']}), short "
          f"neighbours (nl {r1['nl']}, nr {r1['nr']}, h_cap {h_cap})")
    print("[slab corner] capped band walks, rows per lane (max over a warp) "
          "by rank: " + ", ".join(f"{r['capped_stats']['warp_max']:.1f}"
                                  for r in ranks))
    del st
    for name in (n for n in KERNELS if n.endswith("[slab]")):
        t = times[name]
        print(f"[slab 1M] {name}: kernel {t['ms']:.4f} ms, plain twin "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.3f} us "
              f"({t['bound_by']}: {t['bytes']} bytes, {t['flops']} flops on "
              f"{pairs[name]} pairs)")

    # 12. the slab engine at world size 1 vs the single-chip lazy step: one
    #     step from the same 1M splash state
    for label, ov in (("exact", SLAB), ("capped", SLAB_CAPPED)):
        cfg, st, zsplit, caps, sub_len = slab_setup(
            1_000_000, ov, SLAB_HEADROOM, dev)
        one, d1 = drive_loop_lazy(resolve_sweep_settings(cfg, st, ov), st, 1)
        with local_group(dev) as grp:
            r = slabs.run_slab_steps(grp, cfg, st, caps, zsplit, 1,
                                     sweeps="pallas", sub_len=sub_len)
        nc = one.neighbor_count
        n = st.n
        mean_1 = torch.tensor(float(nc.long().sum()), dtype=torch.float32) \
            / torch.tensor(float(n), dtype=torch.float32)
        sd = {k: v[0] for k, v in r["diags"].items()}
        stats = ((float(sd["neighbor_mean"]), int(sd["neighbor_max"]),
                  int(sd["neighbor_min"])),
                 (mean_1.item(), int(nc.max()), int(nc.min())))
        ke = (float(sd["kinetic_energy"]), d1.kinetic_energy[-1].item())
        pe = (float(sd["potential_energy"]), d1.potential_energy[-1].item())
        r_pos = rel_l2(torch.from_numpy(r["position"]), one.position.cpu())
        print(f"[slab vs single 1M {label}] neighbor (mean, max, min) slab "
              f"{stats[0]} single {stats[1]} (single-chip diag mean "
              f"{d1.neighbor_mean[-1].item()}); KE {ke}; PE {pe}; position "
              f"rel_l2={r_pos:.3e}; truncated {int(sd['truncated_ranges'])} "
              f"vs {int(d1.truncated_ranges[-1])}")
        check(stats[0] == stats[1], f"slab vs single {label}: neighbor stats")
        for what, (a, b) in (("KE", ke), ("PE", pe)):
            check(abs(a - b) <= 1e-5 * max(abs(b), 1e-30),
                  f"slab vs single {label}: {what} {a} vs {b}")
        check(r_pos <= 1e-6, f"slab vs single {label}: positions {r_pos}")
        check(int(sd["truncated_ranges"]) == 0 and r["ids_once"],
              f"slab vs single {label}: no loss")
        del one, st, r

    # 13. two ranks on the one card (gloo: NCCL refuses two ranks on one
    #     device) vs the same engine at world size 1, 32k splash on 32^3
    kw = dict(num_particles=32768, grid_nx=32, grid_ny=32, grid_nz=32,
              cell_size_factor=1.25)
    for label, ov in (("exact", dict(pallas_window_t=64)),
                      ("capped", dict(capped_candidates=4, pallas_block_t=256,
                                      pallas_window_t=32)),
                      ("fused", dict(capped_candidates=4, pallas_block_t=256,
                                     pallas_window_t=32, capped_fused=True))):
        cfg, st = make_scene("splash", device=dev, **kw, **ov)
        runs = {}
        for world in (1, 2):
            zsplit = slabs.derive_zsplit(cfg, st, world)
            caps = slabs.derive_slab_caps(cfg, st, world, zsplit=zsplit)
            job = dict(cfg=cfg, state=state_to_numpy(st), caps=caps,
                       zsplit=zsplit, steps=2, sweeps="pallas",
                       sub_len=slabs.derive_sub_len_slab(cfg, st, world,
                                                         zsplit) or None)
            t0 = time.perf_counter()
            if world == 1:
                with local_group(dev) as grp:
                    runs[1] = slabs.run_slab_steps(grp, **job)
            else:
                outs = spawn_ranks(2, slabs.run_slab_jobs, [job],
                                   backend="gloo", devices=["cuda:0"] * 2,
                                   timeout_s=300.0)
                runs[2] = outs[0][0]
                halos = [o[0]["band_halo"] for o in outs]
                ran = [{k: v for k, v in o[0]["launches"].items() if v}
                       for o in outs]
                print(f"[ranks {label} 32k] world 2: live halo rows (left, "
                      f"right) of the exact band tables per rank {halos}; "
                      f"slab launches per rank {ran}")
                if label == "exact":
                    # the live halos reach the band kernels on both ranks
                    check(halos[0][1] > 0 and halos[1][0] > 0
                          and all(r == {"density_ext": 2, "force_ext": 2}
                                  for r in ran),
                          f"ranks exact: band kernels with live halos "
                          f"{halos} {ran}")
            wall = time.perf_counter() - t0
            d = runs[world]["diags"]
            print(f"[ranks {label} 32k] world {world}: zsplit {zsplit} caps "
                  f"{caps} counts {runs[world]['counts']} rebins "
                  f"{runs[world]['rebins']}; neighbor mean "
                  f"{d['neighbor_mean'].tolist()} max "
                  f"{d['neighbor_max'].tolist()} min "
                  f"{d['neighbor_min'].tolist()}; KE "
                  f"{d['kinetic_energy'].tolist()}; losses "
                  f"{int(d['truncated_ranges'].sum())} "
                  f"{int(d['halo_dropped'].sum())} "
                  f"{int(d['migration_dropped'].sum())}; wall {wall:.2f} s")
        a, b = runs[2], runs[1]
        for k in ("neighbor_mean", "neighbor_max", "neighbor_min"):
            check(bool((a["diags"][k] == b["diags"][k]).all()),
                  f"ranks {label}: {k} world 2 == world 1")
        ke_a, ke_b = a["diags"]["kinetic_energy"], b["diags"]["kinetic_energy"]
        check(bool((abs(ke_a - ke_b) <= 1e-5 * abs(ke_b)).all()),
              f"ranks {label}: KE {ke_a} vs {ke_b}")
        for k in ("truncated_ranges", "halo_dropped", "migration_dropped"):
            check(not a["diags"][k].any(), f"ranks {label}: {k} 0")
        check(a["ids_once"] and a["rebins"] == 1,
              f"ranks {label}: every id once, one rebuild")
        check(sum(a["counts"][0]) == st.n and min(a["counts"][0]) > 0,
              f"ranks {label}: both ranks populated")
        del st, runs

    # 14. the slab main paths, counted (the block walks too: no slab path
    #     may run them); then single-chip and slab in turns
    for path, (ov, names) in SLAB_PATHS.items():
        reset_launches()
        with counting_block_walks() as block_walks:
            r = run_slab_benchmark(n=1_000_000, steps=STEPS, warmup=WARMUP,
                                   headroom=SLAB_HEADROOM, overrides=ov,
                                   device="cuda")
        counts = {name: wrapper(name).launches for name in KERNELS}
        total_steps = r["warmup_steps"] + r["steps"]
        print(f"[main {path}] 1M splash, one rank ({r['device']}): "
              f"{r['ms_per_step']:.4f} ms/step, {r['value']:.6e} "
              f"particle-steps/s over {r['steps']} steps (warmup "
              f"{r['warmup_steps']} steps, {r['warmup_s']:.2f} s); window_t "
              f"{r['window_t']} block_t {r['block_t']} sub_len {r['sub_len']} "
              f"p_cap {r['p_cap']} h_cap {r['h_cap']}; rebins in timed steps "
              f"{r['rebins']}; launches "
              f"{ {k: v for k, v in counts.items() if v} } for {total_steps} "
              f"steps; max truncated {max(r['truncated_ranges'])}, halo "
              f"{max(r['halo_dropped_steps'])}, migration "
              f"{max(r['migration_dropped_steps'])}; neighbor mean "
              f"{r['neighbor_mean'][-1]:.4f}; KE {r['kinetic_energy'][0]:.6e} "
              f"-> {r['kinetic_energy'][-1]:.6e}; finite={r['finite']}")
        for name in names:
            check(counts[name] == total_steps, f"{path}: {name} launched "
                  f"{counts[name]} times in {total_steps} steps")
            launches[name] = counts[name]
        no_block_walk(path, block_walks)
        for k in ("truncated_ranges", "halo_dropped_steps",
                  "migration_dropped_steps"):
            check(len(r[k]) == total_steps and max(r[k]) == 0,
                  f"{path}: {k} {r[k]}")
        check(r["finite"], f"{path}: store and KE finite")
    turns = []
    for kind in ("single", "slab", "slab", "single"):
        if kind == "single":
            r = run_benchmark(scene="splash", lazy=True, steps=STEPS,
                              warmup=WARMUP, overrides=MAIN, device="cuda",
                              backend="pallas")
        else:
            r = run_slab_benchmark(n=1_000_000, steps=STEPS, warmup=WARMUP,
                                   headroom=SLAB_HEADROOM, overrides=SLAB,
                                   device="cuda")
        turns.append((kind, r["ms_per_step"], r["window_t"]))
    print(f"[turns exact 1M] (engine, ms/step, window_t): {turns}")

    # 15. the hardware probes (tools/probe_*.py): every op and mode of the
    #     three probe kernels against its plain version at the JAX probes'
    #     shapes, then the three probes' main runs, counted
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_gather, probe_mxu, probe_vpu_ops)

    t0 = time.perf_counter()
    errs["chain_kernel"] = vpu_vs_plain(dev)
    errs["gather_tile_kernel"] = gather_vs_plain(dev)
    errs["d2_tile_kernel"] = mxu_vs_plain(dev)
    gather_in_turns(dev)
    queued_timer(dev)
    chain_ranges(dev)
    reset_launches()
    vpu, gat, mxu = probe_vpu_ops.main(), probe_gather.main(), probe_mxu.main()
    for name in PROBE_KERNELS:
        launches[name] = wrapper(name).launches
        check(launches[name] > 0, f"probe run: {name} launched")
    check(mxu["ok"], "d^2 probe: every mode within 1e-4 at the JAX shapes")
    sass_checks(vpu["sass"], vpu["sass_body"])
    times.update(probe_records(dev, vpu, gat, mxu))
    for name in PROBE_KERNELS:
        t = times[name]
        print(f"[probe] {name} ({t['case']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library "
              + ("none" if t["library_ms"] is None
                 else f"{t['library_ms']:.4f} ms")
              + f", bound {t['bound_ms'] * 1e3:.1f} us ({t['bound_by']}"
              + (f": {t['bound_class']}" if "bound_class" in t else "")
              + f"), {t['bound_ms'] / t['ms']:.0%} of it; "
              f"{launches[name]} launches in the probe run")
    print(f"[probe] phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. the CLI on the card: the reference's headless run with its
    #     outputs and checkpoints, resumes, an apply, the 1M splash's
    #     outputs, info, watch and a sweep
    cli_phase(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name]["ms"],
         "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms"),
         **({"caller": k.caller} if k.caller else {}),
         **({"case": times[name]["case"]} if "case" in times[name] else {})}
        for name, k in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def stop_resource_tracker() -> None:
    """Stop and reap multiprocessing's resource tracker, if this process
    started one.

    ``spawn_ranks`` (phases 11-14) starts its ranks with the ``spawn``
    method, which starts the tracker as a child of this process; left
    alone, it outlives the script until it reads the end of its pipe.  The
    ranks are joined by then and their queues collected first, so the
    tracker holds nothing to clean up when it stops.
    """
    from multiprocessing import resource_tracker

    gc.collect()
    resource_tracker._resource_tracker._stop()


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_resource_tracker()
    sys.exit(code)
