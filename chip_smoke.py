#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA GPU, sm_90a).

    python3 chip_smoke.py

Phases (every failed check raises, and the script exits nonzero):

1. build the kernels (``csrc/sweep_t.cu``, ``csrc/sweep_lane.cu``,
   ``csrc/probes.cu``, ``csrc/floor_t.cu``, ``csrc/integrate_t.cu``,
   ``csrc/cand_cols_t.cu``: ``LIBRARIES``) with nvcc, one process per
   source, started together;
   print the build time and ptxas's register/spill report;
2. exact mode, 32k splash: K1 and K2, the per-lane band walks
   (``density_band_t``, ``force_band_t``), against their plain PyTorch twins
   on the card, which walk the same bands on the same arguments (neighbor
   counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4); two launches of
   each on the same tensors bit-equal (the walk is deterministic); the
   counter kernel ``band_rows_t`` (the lane-rows of a band sweep,
   ``sweeps.rows_tested``) equal to its twin, 32 times
   ``walk_stats.band_sums``' warp union, exactly; K2's own counters (its
   pairs and its warps' drain rounds, ``sweeps.force_pairs`` and
   ``sweeps.force_rounds``) equal to its twin's (``walk_stats.drain_sums``)
   and its pairs to K1's counts, exactly, with the share of lanes its drain
   rounds keep busy (at 1M beside K2's time in the kernels line; capped
   the same in phases 5 and 7);
3. exact mode, 4096-particle splash: the kernel-backed step quantities
   against the O(N^2) pairwise oracle, with the same bars;
4. exact mode, 1M splash shapes: the same checks at the main path's
   shapes, the rows tested per lane (band mean, max over a warp, warp
   union), and the kernel and twin times (CUDA events);
5. capped mode (K_c = 4), 32k splash: capped K1 and K2, the per-lane band
   walks over the sub frame (``density_band_t<capped>``,
   ``force_band_t<capped>``), the fused path's pre-pass K1 and K3, band
   walks over the same table (``density_band_t<prepass>``,
   ``fused_band_t``), against their twins (the pre-pass on the kept sub
   rows; its tail rows count 0), each launched twice bit-equal; K3's rho
   and counts bit-equal to capped K1's; the pre-pass's rows per lane;
   ``band_rows_t`` over the sub frame's table equal to its twin;
6. capped mode, 4096-particle splash with a keep-all cap (K_c = the largest
   cell occupancy), two-pass and fused, against the pairwise oracle;
7. capped mode, 1M splash shapes: the same checks, the rows tested per
   lane, the kernel and twin times, and the capped density mean over the
   exact one on the same state in (0.99, 1.01) (the sampling is unbiased);
8. lane layout, 32k packed splash with 128-row windows (multi-chunk) and the
   1M lane splash shapes (window 512): the per-lane band walks
   ``density_band_lane`` and ``force_band_lane`` against their twins, each
   launched twice bit-equal; then a clamped case (a few 16^3-grid cells
   each holding more than 127 windows of rows, so ``truncated_ranges`` >
   0), launched twice bit-equal; the rows tested per lane at 1M (band mean,
   max over a warp, warp union) beside the block window's rows per thread,
   kernel and twin times;
9. backend parity: ``run_parity_check`` on the 32k disk (sublane kernels
   against the cell-list sweeps), then lane against cell-list and lane
   against sublane on the same states of the 32k disk and the 100k dam
   break, with the same bars;
10. the main paths, each with the launch counters reset just before:
   ``run_benchmark`` drives the 1M lazy splash (3 warmup + 20 timed steps)
   exact, capped two-pass and capped fused (bench.py's ``capped_k4`` row:
   block 256, window and sub-frame length derived), then the 1M lane splash
   eager (rebinned every step) for 3 + 20 steps.  Each kernel of a path
   must have launched once per step, the integrator's kernel
   ``integrate_t`` too, and K2's (K3's) candidate columns' kernel
   ``cand_cols_t`` on the lazy paths (none on the lane path), and no
   ``band_rows_t`` (no profiler records) on any path, no step may drop
   candidates
   (``truncated_ranges`` 0) and the final state must be finite; after the
   capped run, one lazy step from the same state, capped and exact, must
   give densities whose means agree within 1 %.  Last, the
   32k disk runs 100 steps under the lazy sublane driver (central gravity,
   ``second_kick="gravity"``), printing KE, PE and |L| at the start and
   the end, with a finite state, each of its kernels (``cand_cols_t``
   too) launched once a step;
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
   1e-6, acc rel-L2 <= 1e-4 (the exact pair on the live rows, the
   pre-pass on the kept rows), every row finite, the dead rows 0, each
   kernel launched twice bit-equal; kernel and twin times with their
   bounds (the exact band kernels launched on the live rows the wrappers
   gather, so time and bound are the kernels'); rows tested per lane (band
   mean, max over a warp, warp union) equal to the single-chip band walks'
   on the same state (capped: the same cell-start table too).  Then the
   engine's 4 ranks (``spawn_ranks``, gloo, all on cuda:0, each with its
   own ``prepare_frame``) on a box whose rank-1 corner cells are populated
   and whose ranks 0 and 2 hold fewer rows than ``h_cap``
   (``walk_stats.corner_state``): the same checks on every rank, exact,
   capped and fused, and the rows a table over the raw frame would test on
   rank 1;
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
   20 timed steps: each kernel of a path launched once per step,
   ``cand_cols_t`` too, no counted loss, a finite state; then
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
   its plain version (FMA and 3xTF32 against the f32 one too); the floor
   kernels (``tools/probe_dma_floor.py``: ``floor_window_t``, the TPU
   probe's window walk, and ``floor_band_t``, the band kernels' walk at W
   4 and 9) against their plain versions, rel-L2 <= ``FLOOR_BAR``, finite,
   band ``halfbytes`` bit-equal to band ``full``: every walk, mode and K on
   the 32k splash, K = 2 capped (K_c 4, 256-row blocks), ``full`` and
   ``nostage`` at K = 2 on the 1M splash, which gives their records;
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
   chain bounds come from, at least its ``MIX`` floor);
16. the CLI in this process, as a user runs it (``cli_phase``): ``run``
   with no scene flags (the 32k disk's 1,001 lazy steps, checkpointed every
   500, K1/K2 counted, the five files, ``run.json``, ``final_state.npz``,
   a bit-equal checkpoint round trip), resumes from 1,000 and from 500
   with ``--apply``, the 1M splash's ``run`` beside ``run_benchmark``,
   ``info``, ``watch --once`` and a ``sweep``;
17. the renderer, lane groups, compat mode and the examples
   (``slice_phase``; none has a kernel of its own): the 1M splash and a 1M
   uniform cloud (drawn at gain 1, so a particle moved across a pixel edge
   shows) rendered on the card byte-equal to the same states on the CPU
   (orthographic, voxels, perspective with the box at two cameras and
   without it), the splash's ms per frame; ``run --render --live
   --live-term`` on the 32k disk's lazy path (K1/K2 counted, the GIF, the
   live PNG, one repaint a block) and ``render`` of phase 16's checkpoint,
   its PNG equal to the CPU's; the exact 1M lazy splash at
   ``pallas_groups`` 1, 2, 4 (the sort and cell starts on the card
   bit-equal to the CPU's, counts, rho, acc, positions and velocities
   bit-equal to G = 1, K1/K2 counted), the band kernels against their
   twins at G = 2 on the 32k splash, the one-rank slab exact step at G = 2 bit-equal to G = 1, and
   ms/step at G = 1, 2, 4 in turns; compat mode on the 32k exact-IC disk
   (step-0 neighbor ids, counts and stored distances bit-equal to the
   CPU's, 10 compat steps: counts equal, positions rel-L2 <= 1e-6, acc
   rel-L2 <= 1e-4; its ms/step, and ``utils/profile_step.py --backend
   compat``'s host ops and busy share), ``run --compat --exact-ic`` and
   ``parity`` on dumps of the CPU's trajectory (PASS); both examples under
   ``SPH_EXAMPLE_QUICK=1`` on the card;
18. the multi-rank work (``devices_phase``; no kernel of its own): ``run
   --devices 2 --partition slab --backend pallas`` on the 1M splash (1.25h
   cells), exact, capped (K_c 4) and fused, 20 steps in blocks of 10 with
   ``--rebalance-threshold 1.5`` and ``--checkpoint-every 10``, then
   ``--resume`` of the fused run for 10 more: on every rank each slab
   kernel of the mode launched once a step and nothing else, reported by
   the ranks as their pool closes; ``diagnostics.jsonl``
   with no counted loss, a finite ``final_state.npz`` holding every
   particle once, the exact run's band tables with live halo rows on both
   inner sides, ``run.json``'s ranks and comm backend; the exact run and a
   second one in turns with the single-device ``run`` (single, slab, slab,
   single); ``run --devices 2 --partition halo`` (cell-list, 3 steps, no
   loss); in one spawn of two ranks from one 1M splash state, one step by
   the halo step and the gather oracle at world 2 against the
   single-device cell-list step (counts equal, rho, positions and
   velocities rel-L2 <= 1e-6, KE rel <= 1e-5, every rank sorted alike),
   then the slab exact step with its collectives and their device-host
   copies timed (the share of gloo's host staging);
   ``graft_entry.dryrun_multichip`` at 2 and 4 ranks;
   ``examples/distributed.py`` (quick size); NCCL at ``--devices 2`` only
   on two cards, else
   one line saying it was not run.  On one card every group is gloo ranks
   sharing cuda:0 (NCCL refuses two ranks on one device);
19. the study and profiling tools (``tools_phase``; no kernel of their
   own), each through its ``main``: ``capped_fullrun`` at full duration
   (the 32k disk 1,001 steps and the 1M splash 1,000, exact and capped
   K_c 4) held to the JAX record's envelopes (KE tail ratio, capped
   energy drift, same-state density ratios, the cap binding), K1/K2 exact
   and capped counted; ``capped_noise`` at 1M (rel-L2 in (0, 1), mean
   ratio within 1 %); ``trace_drift`` (1M) and ``ab_engines`` (8192) for
   24 steps (the engines' positions rel-L2 <= 1e-5 until the lazy
   driver's first rebin); ``profile_pallas``, ``profile_prepare`` (its
   rebuild bit-equal to ``prepare_t`` on the card), ``profile_lazy``,
   ``profile_slab --phases`` and ``profile_step`` once at 1M;
   ``ab_dials`` with two variants for two rounds and ``ab_slab``'s
   baseline; ``microbench``, each op equal to numpy's result; then the
   five probes (``tools_probes``): ``probe_dma_floor`` at 1M exact and
   K_c 4, the floor kernels counted from 0 (their launches in the kernels
   line: no step path runs them), ``probe_cond``, ``probe_scan`` on the 32k
   disk and the 1M splash (K frozen steps as one CUDA graph),
   ``probe_dispatch`` and ``probe_tally`` (its five formulations' KE, PE
   and |L| within ``TALLY_BAR`` of ``kdk_integrate``'s), every time finite;
   last ``scale_projection`` (``tools_projection``) at 125k a card of an
   8-card run (``grid_nz`` 16), both slab rows in processes of their own,
   no drop, no truncation, every time finite;
20. the single-card 10M configurations (``tenm_phase``): ``bench.py``'s
   ``capped_k4_10m`` row (the splash, K_c 4) and the 10M dam break
   (exact, window 208), each first as a state whose K1 and K2 are held
   against their twins over every row (counts equal, rho rel-L2 <= 1e-6,
   acc rel-L2 <= 1e-4) and ``band_rows_t`` equal to its twin, then as its ``bench`` loop through the CLI with
   its K1/K2 counted from 0: ms/step, rebins, ``truncated_ranges`` (0 in
   every step), window, sub frame and the peak allocated memory printed,
   every value finite;
21. the integrator's kernel (``integrate_phase``; ``csrc/integrate_t.cu``,
   no TPU kernel: the JAX integrator is plain ``jnp``) against its twin
   ``kdk_integrate_plain`` on the first lazy-step input of the benchmark's
   1M splash and 10M dam break (``INTEGRATE``), at their settings and with
   the gravity kick and a central mass: positions and velocities
   bit-equal (a NaN against a NaN counted equal), each tally term at most
   twice the twin's distance from the float64 sum of the twin's terms or
   one float32 ulp of it, two calls' tallies bit-equal; then the kernel's
   and the twin's times (queued CUDA events) beside the bound, 64 B a row
   at the HBM rate;
22. K2's candidate columns (``cand_phase``; ``csrc/cand_cols_t.cu``, no
   TPU kernel: XLA fuses the JAX ``fused_cand_cols``) against their twin
   ``fused_cand_cols_plain`` on the first step's K2 input of the
   benchmark's 1M splash, 10M dam break and 10M capped splash (``CAND``;
   capped, the indexed instance through ``sub_perm``, and the gathered
   rows unindexed) and on the 1M one-rank slab frame's row-strided column
   views: every column bit-equal (a NaN against a NaN counted equal); the
   kernel's and the twin's times (queued CUDA events) beside the bound,
   68 B a row (indexed: the sectors the index touches) at the HBM rate;
   then the kernel launched once a step in a counted 5-step solve of each
   of the four configurations.

It then prints the card's name and power limit, one JSON line of kernel
records (time, twin time, launches, error, and the bound: the larger of the
bytes each call must move over 3.35 TB/s and the flops on the pairs within
h over 67 TFLOP/s f32, the H100 SXM's published peaks; for a probe, at the
case its record names, the chain's instructions counted from its unrolled
body's SASS over the card's issue rates (f32, MUFU and integer work;
control left out), the gather's bytes, the d^2
tile's tensor-core flops over 495 TFLOP/s TF32, or the floor ladder's
lane instructions, K + 2 a tested lane-row, over the card's 128 lanes a
clock a SM (``tools/probe_dma_floor.py``'s ``ladder_ops`` and
``issue_ms``, the tool's own count), and the PyTorch call that
computes the same function as ``library_ms``; under ``counters``, the
counter kernel ``band_rows_t``'s launches in the main paths, 0; under
``integrate``, the integrator's kernel's launches in the 1M exact path and
its times at 1M and 10M beside its bound; under ``cand_cols``, the
candidate columns' kernel's launches in the main path of each input's
mode (``CAND_PATH``; phases 10 and 14: once a step on every lazy path,
none on the lane path), its times at each input beside its bound and its
launches in the counted solve), and last
``{"ok": true,
"device": {...}}``.  With no CUDA device it exits 1 before printing any result.
On every exit it stops the resource tracker that the spawned ranks started,
so no process of the script outlives it (every rank pool and spawn of
phases 11-14 and 18 joins its ranks before it returns).
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

import numpy as np
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
SOURCE_FLOOR = f"{PKG}/csrc/floor_t.cu"
SOURCE_INTEGRATE = f"{PKG}/csrc/integrate_t.cu"
SOURCE_CAND = f"{PKG}/csrc/cand_cols_t.cu"
# the CUDA sources, one library each (utils/build.py)
LIBRARIES = ("sweep_t", "sweep_lane", "probes", "floor_t", "integrate_t",
             "cand_cols_t")
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
    #                      ("vpu", "gather", "mxu", "floor": tools/probe_*.py)
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
    # the floor probe's two walks: one TPU kernel, _probe_kernel
    "floor_window_t": Kernel("floor", "floor_window_t", "floor_window_t_plain",
                             SOURCE_FLOOR, "tools/probe_dma_floor.py:61", 0),
    "floor_band_t": Kernel("floor", "floor_band_t", "floor_band_t_plain",
                           SOURCE_FLOOR, "tools/probe_dma_floor.py:61", 0),
}
FLOOR_KERNELS = ("floor_window_t", "floor_band_t")
PROBE_KERNELS = ("chain_kernel", "gather_tile_kernel", "d2_tile_kernel",
                 *FLOOR_KERNELS)
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
    from smoothed_particle_hydrodynamics_tpu_torch.ops import (
        integrate, sweeps_lane, sweeps_t)
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps)
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_dma_floor, probe_gather, probe_mxu, probe_vpu_ops)

    return {"t": sweeps_t, "lane": sweeps_lane, "slab": slab_sweeps,
            "vpu": probe_vpu_ops, "gather": probe_gather, "mxu": probe_mxu,
            "floor": probe_dma_floor, "integrate": integrate}


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


def band_rows(label: str, band: dict) -> None:
    """Print the rows a band kernel tests per lane (``band``: mean, max over
    a warp, warp union, from ``utils/walk_stats.py``)."""
    print(f"[{label}] rows tested per lane: band mean {band['mean']:.1f}, "
          f"band max over a warp {band['warp_max']:.1f}, warp union "
          f"{band['warp_union']:.1f}")


def deterministic(label: str, launches: dict) -> None:
    """Launch each kernel (``launches``: kernel name -> launch) twice on the
    same tensors: every output of the two launches bit-equal, so the walk
    sums its pairs in one order."""
    bits = {}
    for name, launch in launches.items():
        a, b = launch(), launch()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        bits[name] = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    torch.cuda.synchronize()
    print(f"[{label}] two launches on the same tensors bit-equal: {bits}")
    check(all(bits.values()), f"{label}: band walks deterministic {bits}")


def rows_tested_vs_twin(cfg, p, m: int, label: str) -> int:
    """The counter kernel ``band_rows_t`` (the lane-rows a band sweep of the
    self rows tests: ``sweeps.rows_tested``) on ``p``'s bins over ``m``
    candidate rows, equal to its twin (32 times ``walk_stats.band_sums``'
    warp union) exactly, and counted once; returns its lane-rows."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    before = sw.band_rows_t.launches
    got = int(sw.band_rows_t(cfg, p.cid, p.cell_start, m))
    want = int(sw.band_rows_t_plain(cfg, p.cid, p.cell_start, m))
    launched = sw.band_rows_t.launches - before
    print(f"[{label}] band_rows_t: {got} lane-rows a band sweep, twin "
          f"{want}, equal={got == want}, {got / p.cid.shape[0]:.2f} a self "
          f"row; launched {launched}")
    check(got == want > 0, f"{label}: band_rows_t {got} == twin {want}")
    check(launched == int(p.cid.is_cuda),
          f"{label}: band_rows_t launched {launched} times in one call")
    return got


# K2's counters at the main path's shapes, in its kernels-line records
DRAIN_KEYS = ("force_pairs", "force_rounds", "lane_use_pct")


def force_drains(label: str, name: str, args: tuple, pairs: int) -> dict:
    """K2 (``name``) launched on ``args`` with a counter: its pairs and
    drain rounds equal to its twin's (``walk_stats.drain_sums``) and its
    pairs to K1's count of the same bands (``pairs``), exactly; returns
    them and the share of lanes its drain rounds keep busy."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    got, want = (torch.zeros(2, dtype=torch.int64, device=args[1].device)
                 for _ in range(2))
    wrapper(name)(*args, stats=got)
    sw.force_t_plain(*args, stats=want)
    got, want = got.tolist(), want.tolist()
    use = 100.0 * got[0] / (32 * got[1]) if got[1] else float("nan")
    print(f"[{label}] {name} drains: {got[0]} pairs in {got[1]} warp "
          f"rounds, lanes busy {use:.2f} %; twin {want}, K1 pairs {pairs}")
    check(got == want and got[0] == pairs,
          f"{label}: {name} counters {got} == twin {want}, pairs == {pairs}")
    return dict(force_pairs=got[0], force_rounds=got[1], lane_use_pct=use)


def exact_vs_twins(cfg, p, label: str):
    """Exact K1 and K2, the band walks, against their twins on the same
    card tensors (the twins take the kernels' arguments), each launched
    twice bit-equal.  Returns the max abs errors, the kernel and twin
    arguments and the tensors each kernel reads (for timing and its bound)
    and the pairs within h each kernel sums."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        band_rows_per_lane)

    n = p.pos_s.shape[0]
    args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.cell_start)
    twin_d = (*args_d, p.pos_s, p.mass_s)
    rho_k, nc_k = sw.density_t(*args_d)
    rho_p, nc_p = sw.density_t_plain(*twin_d)
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_k, p.mass_s)
    args_f = (cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.cell_start)
    acc_k, acc_p = sw.force_t(*args_f), sw.force_t_plain(*args_f)
    band_rows(label, band_rows_per_lane(cfg, p.cid, p.cell_start, n))
    deterministic(label, {"density_band_t": lambda: sw.density_t(*args_d),
                          "force_band_t": lambda: sw.force_t(*args_f)})
    rows_tested_vs_twin(cfg, p, n, label)
    errs = {"density_band_t": agree(label, "density_band_t", rho_k, rho_p,
                                    (nc_k, nc_p)),
            "force_band_t": agree(label, "force_band_t", acc_k, acc_p,
                                  bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    args = {"density_band_t": args_d, "force_band_t": args_f}
    twin_args = {"density_band_t": twin_d, "force_band_t": args_f}
    # the sums need the rows and cids only: cell_start is the kernels' own
    # index, of which they read just the entries next to occupied cells
    reads = {"density_band_t": (p.pos_s, p.mass_s, p.cid),
             "force_band_t": (p.pos_s, p.vel_s, rho_k, cand, p.cid)}
    return (errs, (args, twin_args, reads),
            {"density_band_t": pairs, "force_band_t": pairs})


def tail_rows(label: str, kept: int, counts: torch.Tensor) -> None:
    """The pre-pass's unkept tail rows (past ``kept``) walk empty bands:
    count 0 on every one."""
    tail = not counts[kept:].any()
    print(f"[{label}] pre-pass tail rows count 0: {tail}")
    check(tail, f"{label}: pre-pass tail rows count 0")


def capped_vs_twins(cfg, p, label: str):
    """The four capped kernels, all band walks over the sub frame's table,
    against their twins on the same card tensors (the twins take the
    kernels' arguments), each launched twice bit-equal, the pre-pass's tail
    rows counting 0, and K3's rho/counts against capped K1's (bit-equal).
    Returns the max abs errors, the kernel and twin arguments and the
    tensors each kernel reads (for timing and its bound) and the pairs
    within h each kernel sums."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        band_rows_per_lane, prepass_rows)

    pos_c, vel_c = sw.gather_sub_pv(p)
    mass_c = p.mass_s[p.sub_perm]
    s_len = p.sub_perm.shape[0]
    n_kept = int((p.cand_cid >= 0).sum())
    print(f"[{label}] block={cfg.pallas_block_t} S={s_len} kept={n_kept} "
          f"sub_dropped={int(p.sub_dropped)}")
    args = {
        "density_band_t<capped>": (cfg, p.pos_s, p.mass_s, p.cid,
                                   p.cell_start, pos_c, p.wm_sub, p.sub_perm),
        "density_band_t<prepass>": (cfg, pos_c, mass_c, p.wm_sub, p.cand_cid,
                                    p.sub_perm, p.cell_start),
    }
    rho_k, nc_k = sw.density_capped_t(*args["density_band_t<capped>"])
    rho_p, nc_p = sw.density_t_plain(*args["density_band_t<capped>"])
    sub_k = sw.density_pre_t(*args["density_band_t<prepass>"])
    # the pre-pass band walk's and twin's counts: the walk's own arguments
    pre = sw._pre_args(*args["density_band_t<prepass>"])
    sub_bk, sub_nk = sw._launch_density_band(
        *pre, kernel="density_band_t<prepass>")
    sub_p, sub_nc = sw.density_t_plain(*pre)
    # the force candidates' densities: rho at their sorted rows (two-pass)
    # or the pre-pass output (fused)
    cand_2 = sw.fused_cand_cols(cfg, pos_c, vel_c, rho_k[p.sub_perm], p.wm_sub)
    cand_f = sw.fused_cand_cols(cfg, pos_c, vel_c, sub_k, p.wm_sub)
    args["force_band_t<capped>"] = (cfg, p.pos_s, p.vel_s, rho_k, cand_2,
                                    p.cid, p.cell_start, p.sub_perm)
    args["fused_band_t"] = (cfg, p.pos_s, p.vel_s, p.mass_s, p.cid,
                            p.cell_start, cand_f, p.sub_perm)
    acc_k = sw.force_capped_t(*args["force_band_t<capped>"])
    acc_p = sw.force_t_plain(*args["force_band_t<capped>"])
    facc_k, frho_k, fnc_k = sw.fused_t(*args["fused_band_t"])
    facc_p, frho_p, fnc_p = sw.fused_t_plain(*args["fused_band_t"])
    torch.cuda.synchronize()
    band_rows(label, band_rows_per_lane(cfg, p.cid, p.cell_start, s_len))
    band_rows(f"{label} pre-pass", prepass_rows(cfg, p.cand_cid,
                                                p.cell_start))
    deterministic(label, {name: lambda name=name, a=a: wrapper(name)(*a)
                          for name, a in args.items()})
    rows_tested_vs_twin(cfg, p, s_len, label)
    check(bool(torch.equal(sub_bk, sub_k)),
          f"{label}: pre-pass wrapper == its launch")
    tail_rows(label, n_kept, sub_nk)
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
    return errs, (args, args, reads), pairs


def lane_vs_twins(cfg, st, label: str, twins: bool = True):
    """The lane band kernels on the card, each launched twice bit-equal on
    the same tensors, and (``twins``) against their twins, with no chunk
    cut by the 127 clamp.  Returns the max abs errors, the kernel and twin
    arguments and the tensors each kernel reads (for timing and its bound)
    and the pairs within h each kernel sums; or, without ``twins``, the
    chunks the clamp cut."""
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
          f"block={cfg.pallas_block_rows} truncated={truncated}; block window"
          f" {lane_rows_per_thread(cfg, p):.1f} rows per thread")
    band_rows(label, lane_band_rows_per_lane(cfg, p))
    deterministic(label, {"density_band_lane": lambda: sl.density_lane(
        *args_d), "force_band_lane": lambda: sl.force_lane(*args_f)})
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
            {"density_band_lane": pairs, "force_band_lane": pairs})


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


def slab_exact_vs_twins(cfg, group, frame, caps, label: str):
    """The slab engine's exact K1/K2, the band walks over the live rows of
    one rank's frame (``slabs.prepare_frame``), against their twins on the
    same card tensors (the twins take the kernels' arguments): on the live
    own rows within the bars; the dead rows 0; every row finite; each
    launched twice bit-equal.  The halo rows' densities come from the
    neighbours (``exchange_rho`` on ``group``).  Prints the rows tested per
    lane.  Returns the max abs errors, the wrapper arguments, the pairs
    within h, the band kernels' launches on the gathered live rows and the
    tensors each reads (for its time and bound: each live row once), both
    by kernel name, and the band statistics."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        slab_band_rows_per_lane)

    p_cap, h_cap, _ = caps
    ext, f = frame.ext, frame
    cnt = f.count
    band, = f.tabs
    print(f"[{label}] p_cap={p_cap} h_cap={h_cap} count={cnt} "
          f"block={sw._blane(cfg)} live rows {band.rows.shape[0]} "
          f"(left halo {band.nl}, right halo {band.nr})")
    n_d, n_f = "density_band_t[slab]", "force_band_t[slab]"
    args = {n_d: ss.density_local_args(cfg, ext, h_cap, p_cap, band)}
    rho_k, nc_k = ss.density_ext(*args[n_d])
    rho_p, nc_p = ss.density_ext_plain(*args[n_d])
    rho_e = slabs.exchange_rho(group, rho_k, cnt, h_cap)
    args[n_f] = ss.force_local_args(cfg, ext, rho_e, rho_k, h_cap, p_cap,
                                    band)
    acc_k, acc_p = ss.force_ext(*args[n_f]), ss.force_ext_plain(*args[n_f])
    _, pos_l, mass_l = args[n_d][:3]
    _, _, vel_l, _, cand = args[n_f][:5]
    torch.cuda.synchronize()
    finite(label, n_d, rho_k, nc_k)
    finite(label, n_f, acc_k)
    live = slice(0, cnt)
    stats = slab_band_rows_per_lane(cfg, band, cnt)
    band_rows(label, stats)
    dead = not (nc_k[cnt:].any() or rho_k[cnt:].any() or acc_k[cnt:].any())
    print(f"[{label}] dead rows 0={dead}")
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
            None, band.nl, kernel=n_d),
        n_f: lambda: sw._launch_force_band(
            cfg, pos_l, vel_l, rho_k, cand_c, band.cid, band.cell_start, None,
            band.nl, kernel=n_f)}
    deterministic(label, bands)
    reads = {n_d: (band.cid, pos_c, mass_c),
             n_f: (vel_l, rho_k, band.cid, cand_c)}
    return errs, args, {n_d: pairs, n_f: pairs}, (bands, reads), stats


def corner_rank(group, job: dict) -> dict:
    """On one rank of ``spawn_ranks``: its frame of ``job``'s state at the
    first step, built by the engine (``slabs.prepare_frame``), its exact
    band walks held against the twins (``slab_exact_vs_twins``), and, on
    rank 1, the rows a table over the raw frame would test; then its capped
    frame of the same state (``job["capped"]``: config, caps, sub-frame
    length; fused), its capped band walks held the same way
    (``slab_capped_vs_twins``) and its fused pair
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
    stats = slab_exact_vs_twins(cfg, group, frame, caps,
                                f"slab corner rank {d}")[-1]
    band, = frame.tabs
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
    out["capped_stats"] = slab_capped_vs_twins(
        cap["cfg"], group, frame, cap["caps"],
        f"slab corner rank {d} capped")[-1]
    slab_fused_vs_twins(cap["cfg"], group, frame, cap["caps"],
                        f"slab corner rank {d} fused")
    return out


def slab_capped_vs_twins(cfg, group, frame, caps, label: str):
    """The slab engine's capped K1/K2, the band walks over the sub frame's
    table (``SubBand``) of one rank's frame (``slabs.prepare_frame``),
    against their twins on the same card tensors (the twins take the
    kernels' arguments): within the bars on every own row, the dead rows 0,
    every row finite, each launched twice bit-equal.  The halo rows'
    densities come from the neighbours (``exchange_rho`` on ``group``).
    Prints the rows tested per lane.  Returns the max abs errors, the
    wrapper arguments, the pairs within h, the tensors each band kernel
    reads (for its bound: each row once, not the table), all by kernel
    name, and the band statistics."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        slab_sub_band_rows_per_lane)

    p_cap, h_cap, _ = caps
    ext, cnt = frame.ext, frame.count
    sub_src, cand_cid, w_sub, sub_dropped, band = frame.tabs
    s_len = sub_src.shape[0]
    n_kept = int(band.cell_start[-1])
    print(f"[{label}] p_cap={p_cap} h_cap={h_cap} count={cnt} "
          f"block={sw._blane(cfg)} S={s_len} kept={n_kept} "
          f"sub_dropped={int(sub_dropped)}")
    check(n_kept == int((cand_cid >= 0).sum()),
          f"{label}: the table's kept count is the sub frame's")
    n_d, n_f = "density_band_t<capped>[slab]", "force_band_t<capped>[slab]"
    g8 = ext[sub_src.long()]
    args = {n_d: ss.density_local_capped_args(
        cfg, ext, g8, sub_src, w_sub, h_cap, p_cap, band)}
    rho_k, nc_k = ss.density_ext_capped(*args[n_d])
    rho_p, nc_p = ss.density_ext_capped_plain(*args[n_d])
    rho_e = slabs.exchange_rho(group, rho_k, cnt, h_cap)
    args[n_f] = ss.force_local_capped_args(
        cfg, ext, g8, rho_e, rho_k, sub_src, w_sub, h_cap, p_cap, band)
    acc_k, acc_p = ss.force_ext_capped(*args[n_f]), ss.force_ext_capped_plain(
        *args[n_f])
    _, pos_l, mass_l, cpos, cmass = args[n_d][:5]
    _, _, vel_l, _, cand = args[n_f][:5]
    torch.cuda.synchronize()
    finite(label, n_d, rho_k, nc_k)
    finite(label, n_f, acc_k)
    stats = slab_sub_band_rows_per_lane(cfg, band, cnt)
    band_rows(label, stats)
    deterministic(label, {n: lambda n=n: wrapper(n)(*args[n])
                          for n in (n_d, n_f)})
    dead = not (nc_k[cnt:].any() or rho_k[cnt:].any() or acc_k[cnt:].any())
    print(f"[{label}] dead rows 0={dead}")
    check(dead, f"{label}: dead rows write 0")
    errs = {n_d: agree(label, n_d, rho_k, rho_p, (nc_k, nc_p)),
            n_f: agree(label, n_f, acc_k, acc_p, bar=ACC_BAR)}
    pairs = int(nc_k.sum())
    # the sums read the own rows (positions, masses or velocities and rho,
    # the table's self cids), the staged sub-frame columns and src rows,
    # each once, and, as elsewhere, not cell_start, the kernels' own index
    reads = {n_d: (pos_l, mass_l, band.cid, cpos, cmass, sub_src),
             n_f: (pos_l, vel_l, rho_k, band.cid, cand, sub_src)}
    return errs, args, {n_d: pairs, n_f: pairs}, reads, stats


def slab_fused_vs_twins(cfg, group, frame, caps, label: str):
    """The slab engine's fused pair, the sub-frame pre-pass K1 and K3, band
    walks over the sub frame's table (``SubBand``), against their twins on
    one rank's frame (``slabs.prepare_frame`` with ``capped_fused``) on the
    same card tensors, each launched twice bit-equal, the pre-pass's tail
    rows counting 0 and K3's dead rows 0.  Every output row of K3, dead ones
    included, and every kept pre-pass row must be finite.  The halo rows'
    pre-pass densities come from the neighbours (``exchange_rho`` on
    ``group``).  Returns the max abs errors, the arguments used (for
    timing), the pairs within h each kernel sums and the tensors each reads
    (for its bound: each row once, not the table), all by kernel name."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.walk_stats import (
        prepass_rows)

    p_cap, h_cap, _ = caps
    ext, f = frame.ext, frame
    sub_src, cand_cid, w_sub, _, band = f.tabs
    n_kept = int((cand_cid >= 0).sum())
    g8 = ext[sub_src.long()]
    names = ("density_band_t<prepass>[slab]", "fused_band_t[slab]")
    args = {names[0]: ss.density_sub_local_args(cfg, g8, sub_src, cand_cid,
                                                w_sub, band)}
    sub_k = ss.density_sub_pre(*args[names[0]])
    _, pos_sub, mass_sub, wm_sub, cid_sub, src_sub = args[names[0]][:6]
    pre = sw._pre_args(cfg, pos_sub, mass_sub, wm_sub, cid_sub, src_sub,
                       band.cell_start)
    sub_bk, sub_nk = sw._launch_density_band(*pre, kernel=names[0])
    # density_sub_pre_plain's own call, keeping the counts
    sub_p, sub_nc = sw.density_t_plain(*pre)
    rho_cand, w_cand = slabs.fused_candidates(slabs.exchange_rho(
        group, slabs.scatter_sub_rho(sub_k, sub_src, cand_cid, h_cap, p_cap),
        f.count, h_cap), sub_src, w_sub)
    args[names[1]] = ss.fused_local_capped_args(
        cfg, ext, g8, rho_cand, sub_src, w_cand, h_cap, p_cap, band)
    facc_k, frho_k, fnc_k = ss.fused_ext(*args[names[1]])
    facc_p, frho_p, fnc_p = ss.fused_ext_plain(*args[names[1]])
    _, pos_l, vel_l, mass_l, cand = args[names[1]][:5]
    torch.cuda.synchronize()
    finite(label, names[0], sub_k[:n_kept])
    finite(label, names[1], facc_k, frho_k, fnc_k)
    check(bool(torch.equal(sub_bk, sub_k)),
          f"{label}: pre-pass wrapper == its launch")
    band_rows(f"{label} pre-pass", prepass_rows(cfg, cid_sub,
                                                band.cell_start))
    deterministic(label, {n: lambda n=n: wrapper(n)(*args[n])
                          for n in names})
    tail_rows(label, n_kept, sub_nk)
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
                         names[1]: int(fnc_k.sum())}, reads)


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


# the floor kernels against their plain versions (phase 15): (n, K_c,
# modes, ks) on the splash at 1.25h cells, window derived (capped: 256-row
# blocks); the 1M exact case also gives their records
FLOOR_CASES = ((32_768, 0, None, None), (32_768, 4, None, (2,)),
               (1_000_000, 0, ("full", "nostage"), (2,)))
FLOOR_RECORD = ("full", 2)
# kernel against plain version, rel-L2 over the self rows: both sum the
# same f32 ladders (the plain version's FMA emulated in f64 and rounded
# once), the kernel row by row within a rod, the plain version by torch's
# reductions
FLOOR_BAR = 1e-5


def floor_vs_plain(dev) -> tuple[dict, dict]:
    """Each floor kernel against its plain version on every walk (window;
    band at W 4 and 9) of ``FLOOR_CASES``: rel-L2 <= ``FLOOR_BAR``, every
    output finite, band ``halfbytes`` bit-equal to band ``full`` (the same
    ladders on the same words).  Returns (max abs error by kernel, the
    kernels' records at 1M exact, ``FLOOR_RECORD``)."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_dma_floor as pf)

    errs, recs = dict.fromkeys(FLOOR_KERNELS, 0.0), {}
    for case in FLOOR_CASES:
        n, k_c, modes, ks = case
        cfg, p = pf.setup(n, k_c, dev)
        label = f"probe floor {n} K_c={k_c}"
        for walk_name, walk in pf.walks(cfg, p).items():
            name = "floor_window_t" if walk_name == "window" else "floor_band_t"
            full = {}
            for mode in modes or pf.MODES:
                for k in ks or pf.KS:
                    a, b = walk["run"](mode, k), walk["plain"](mode, k)
                    torch.cuda.synchronize()
                    r = rel_l2(a, b)
                    fin = bool(torch.isfinite(a).all())
                    print(f"[{label}] {name} {walk_name} {mode} K={k} vs "
                          f"plain: rel_l2={r:.3e} finite={fin}")
                    check(fin and r <= FLOOR_BAR,
                          f"{label}: {walk_name} {mode} K={k} rel-L2 {r} "
                          f"<= {FLOOR_BAR}, finite {fin}")
                    errs[name] = max(errs[name], max_abs(a, b))
                    if mode == "full":
                        full[k] = a
                    elif mode == "halfbytes" and name == "floor_band_t":
                        check(torch.equal(a, full[k]),
                              f"{label}: {walk_name} halfbytes K={k} "
                              f"bit-equal to full")
            if case == FLOOR_CASES[-1] and name not in recs:
                mode, k = FLOOR_RECORD
                kern = lambda w=walk: w["run"](mode, k)
                # the tool's bound: its ladders' lane instructions at the
                # card's issue rate, beside each input read once
                t_bytes = io_bytes(walk["reads"], kern()) / HBM_BYTES_PER_S
                t_ops = pf.issue_ms(pf.ladder_ops(walk, k), dev) * 1e-3
                recs[name] = dict(
                    case=f"{walk_name} walk, 1M splash exact, window "
                         f"{cfg.pallas_window_t}, {mode}, K={k}; no step "
                         f"path launches it (0 a step), launches: the "
                         f"probe's run in phase 19",
                    ms=time_ms(kern, iters=10, warmup=1),
                    plain_ms=time_ms(lambda w=walk: w["plain"](mode, k),
                                     iters=3, warmup=1),
                    bound_ms=max(t_bytes, t_ops) * 1e3,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    bound_bytes_ms=t_bytes * 1e3, bound_ops_ms=t_ops * 1e3,
                    library_ms=None)
    return errs, recs


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


def cli_phase(dev, keep: str | None = None) -> None:
    """Phase 16: ``run``, its checkpoints and resumes, ``info``, ``watch``
    and ``sweep`` through the port's ``__main__.main`` on the card.
    ``keep``: a path to copy the run's last checkpoint to (phase 17 renders
    it)."""
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
        if keep:
            shutil.copy(f"{ck}/ckpt_{2 * CLI_EVERY:08d}.npz", keep)
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


# phase 17: the renderer, lane groups, compat mode and the examples, none
# with a kernel of its own; the groups and the CLI's rendered run step
# through K1/K2
RENDER_CAMERAS = {"persp": {}, "persp az135": dict(
    azimuth=135.0, elevation=0.6, distance=1.8)}
RENDER_REPS = 5
RENDER_SCENE: dict = {}         # the splash at its own size (1M)
GROUPS = (1, 2, 4)
GROUP_STEPS = 3
COMPAT_N = 32 * 1024
COMPAT_STEPS = 10
CLI_RENDER_STEPS, CLI_RENDER_EVERY = 100, 25
CLI_RENDER = ["--steps", str(CLI_RENDER_STEPS), "--block", "25", "--render",
              "--render-every", str(CLI_RENDER_EVERY)]
CLI_COMPAT_STEPS = 100
CLI_COMPAT = ["--compat", "--exact-ic", "--steps", str(CLI_COMPAT_STEPS),
              "--block", "50"]
PROFILE_COMPAT = ["--scene", "disk", "-n", str(COMPAT_N), "--backend",
                  "compat", "--steps", "10", "--warmup", "2", "--repeats",
                  "3"]
EXAMPLES = ("quickstart", "custom_scene")
EXAMPLE_ARGS: list[str] = []    # the examples' flags (the card by default)


def host_ms(fn, reps: int = RENDER_REPS) -> float:
    """Host clock around ``reps`` calls that end on the host (each render
    copies its image to the host), after one warmup call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def render_checks(dev) -> dict:
    """The renders of the 1M splash and of a 1M uniform cloud drawn at
    gain 1 (a pixel holds a few particles, so a particle moved across a
    pixel edge shows) on the card against the same states on the CPU:
    byte-equal images; the card's ms per frame."""
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
    from smoothed_particle_hydrodynamics_tpu_torch.utils.render import (
        render_frame, render_frame_perspective)

    cfg, st = make_scene("splash", device=dev, **RENDER_SCENE)
    gen = torch.Generator().manual_seed(17)
    box = torch.tensor(cfg.box_max)
    cloud = ParticleState.from_arrays(
        (torch.rand(st.n, 3, generator=gen) * box).to(dev),
        torch.zeros(st.n, 3, device=dev), cfg=cfg)
    views = {"ortho": lambda s, g: render_frame(cfg, s, gain=g),
             "voxels": lambda s, g: render_frame(cfg, s, gain=g,
                                                 voxels=True),
             **{name: (lambda s, g, cam=cam: render_frame_perspective(
                 cfg, s, gain=g, **cam)) for name, cam in
                RENDER_CAMERAS.items()},
             "persp no box": lambda s, g: render_frame_perspective(
                 cfg, s, gain=g, box=False)}
    ms = {}
    for label, state, gain in (("splash", st, 40.0), ("cloud", cloud, 1.0)):
        host = ParticleState(*(t.cpu() for t in state))
        diffs = {}
        for name, view in views.items():
            card, want = view(state, gain), view(host, gain)
            diffs[name] = (int((card != want).sum())
                           if card.shape == want.shape else card.size)
            check(diffs[name] == 0 and card.any(), f"render {label} {name}: "
                  f"{diffs[name]} pixels differ from the CPU's")
            if label == "splash":
                ms[name] = host_ms(lambda: view(state, gain))
        print(f"[render] {label} {st.n} (gain {gain}): pixels differing "
              f"from the CPU's render of the same state: {diffs}")
    print(f"[render] splash {st.n} on {dev}, ms per frame (host clock, the "
          f"image on the host, {RENDER_REPS} frames): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms


def cli_render_checks(dev, root: str, ckpt: str | None) -> None:
    """``run --render --live --live-term`` on the 32k disk's lazy path,
    counted, then ``render`` of phase 16's checkpoint, on the card and
    (``--device cpu``) on the CPU: the same PNG bytes."""
    out, live = f"{root}/render_run", f"{root}/live.png"
    reset_launches()
    t0 = time.perf_counter()
    rc, text = cli(["run", *CLI_RENDER, "--out", out, "--live", live,
                    "--live-term", "--quiet"])
    wall = time.perf_counter() - t0
    counts = {name: wrapper(name).launches
              for name in ("density_band_t", "force_band_t")}
    gif = f"{out}/sph_anim.gif"
    want = CLI_RENDER_STEPS // CLI_RENDER_EVERY
    frames = (want if os.path.isfile(gif)
              else len(os.listdir(f"{out}/sph_anim"))
              if os.path.isdir(f"{out}/sph_anim") else 0)
    repaints = text.count("\x1b[2J\x1b[H")
    print(f"[render cli] run {' '.join(CLI_RENDER)} --live --live-term (32k "
          f"disk, lazy): {wall:.2f} s; launches {counts}; "
          f"{'GIF' if os.path.isfile(gif) else 'frame directory'} of "
          f"{frames} frames, live PNG {os.path.getsize(live)} bytes, "
          f"{repaints} terminal repaints")
    check(rc == 0 and f"({frames} frames)" in text and frames == want,
          f"render cli: exit {rc}, {frames} frames")
    last = f"\nstep {CLI_RENDER_STEPS}/{CLI_RENDER_STEPS}\n"
    check(repaints == want and last in text,
          f"render cli: {repaints} repaints")
    check(all(c == CLI_RENDER_STEPS for c in counts.values()),
          f"render cli: K1/K2 launches {counts}")
    if ckpt is None:
        return
    for flags in ([], ["--perspective"], ["--voxels"]):
        pngs = []
        for device in ("cuda", "cpu"):
            png = f"{root}/render_{device}.png"
            rc, _ = cli(["render", ckpt, "-o", png, "--device", device,
                         *flags])
            check(rc == 0, f"render {flags} --device {device}: exit {rc}")
            pngs.append(open(png, "rb").read())
        check(pngs[0] == pngs[1], f"render {flags}: card PNG != CPU PNG")
        print(f"[render cli] render {os.path.basename(ckpt)} {flags}: "
              f"{len(pngs[0])} bytes, the card's PNG equal to the CPU's")


def groups_checks(dev) -> None:
    """Lane groups: the exact 1M lazy splash at G = 1, 2, 4 (the sort and
    cell-start table on the card bit-equal to the CPU's, step quantities
    bit-equal across G, K1/K2 counted); the band kernels at G = 2 against
    their twins on the 32k splash; the one-rank slab exact step at G = 2
    bit-equal to G = 1; ms/step at G = 1, 2, 4 in turns."""
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.ops.lazy import (
        drive_loop_lazy)
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs
    from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import (
        local_group)
    from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        run_benchmark, slab_setup)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.turns import PATHS

    cfg, st = make_scene("splash", device=dev, **MAIN)
    host = ParticleState(*(t.cpu() for t in st))
    outs = {}
    for g in GROUPS:
        cg = cfg.replace(pallas_groups=g)
        p, q = sw.prepare_t(cg, st), sw.prepare_t(cg, host)
        for f in ("order", "cid", "cell_start"):
            check(torch.equal(getattr(p, f).cpu(), getattr(q, f)),
                  f"groups G={g}: prepare_t {f} card != CPU")
        del p, q
        reset_launches()
        out, _ = drive_loop_lazy(cg, st, GROUP_STEPS)
        counts = {name: wrapper(name).launches
                  for name in ("density_band_t", "force_band_t")}
        check(all(c == GROUP_STEPS for c in counts.values()),
              f"groups G={g}: launches {counts}")
        outs[g] = out
    for g in GROUPS[1:]:
        for f in ("neighbor_count", "density", "acceleration", "position",
                  "velocity"):
            check(torch.equal(getattr(outs[g], f), getattr(outs[1], f)),
                  f"groups: {f} at G={g} != G=1")
    print(f"[groups] exact 1M lazy splash, {GROUP_STEPS} steps at G = "
          f"{GROUPS}: order, cell ids and cell starts on the card bit-equal "
          f"to the CPU's; counts, rho, acc, positions and velocities "
          f"bit-equal to G=1; K1/K2 launched once a step")
    del outs, host

    # the band kernels against their twins at G = 2, 32k splash
    cfg, st = make_scene("splash", device=dev, num_particles=32768,
                         cell_size_factor=1.25, pallas_window_t=64,
                         grid_nx=32, grid_ny=32, grid_nz=32, pallas_groups=2)
    p = sw.prepare_t(cfg, st)
    args = (cfg, p.pos_s, p.mass_s, p.cid, p.cell_start)
    rho_k, nc_k = sw.density_t(*args)
    rho_p, nc_p = sw.density_t_plain(*args, p.pos_s, p.mass_s)
    agree("groups 32k G=2", "density_band_t", rho_k, rho_p, (nc_k, nc_p))
    cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_p, p.mass_s)
    args = (cfg, p.pos_s, p.vel_s, rho_p, cand, p.cid, p.cell_start)
    acc_k, acc_p = sw.force_t(*args), sw.force_t_plain(*args)
    agree("groups 32k G=2", "force_band_t", acc_k, acc_p, bar=ACC_BAR)

    # the slab engine at world size 1, exact, G = 2 against G = 1
    cfg, st, zsplit, caps, _ = slab_setup(MAIN["num_particles"], SLAB,
                                          SLAB_HEADROOM, dev)
    runs = {}
    for g in (1, 2):
        with local_group(dev) as grp:
            runs[g] = slabs.run_slab_steps(
                grp, cfg.replace(pallas_groups=g), st, caps, zsplit, 2,
                sweeps="pallas")
    for k, v in runs[1]["diags"].items():
        check(bool((runs[2]["diags"][k] == v).all()), f"slab G=2: {k}")
    for k in ("position", "velocity"):
        check(np.array_equal(runs[2][k], runs[1][k]), f"slab G=2: {k}")
    print(f"[groups] slab exact 1M, one rank, 2 steps: G=2 bit-equal to G=1 "
          f"(diagnostics, collected positions and velocities); neighbor mean "
          f"{runs[2]['diags']['neighbor_mean'].tolist()}")
    del runs, st

    # ms/step at G = 1, 2, 4 in turns (utils/turns.py's paths)
    paths = {1: PATHS["exact"][2], 2: PATHS["groups2"][2],
             4: PATHS["groups4"][2]}
    turns = {g: [] for g in GROUPS}
    for g in [*GROUPS, *reversed(GROUPS)]:
        r = run_benchmark(scene="splash", lazy=True, steps=STEPS,
                          warmup=WARMUP, overrides=paths[g], device="cuda",
                          backend="pallas")
        turns[g].append(r["ms_per_step"])
    print(f"[groups] exact 1M lazy splash ms/step in turns "
          f"(G 1 2 4 4 2 1, {WARMUP} + {STEPS} steps each): "
          + "; ".join(f"G={g} " + " ".join(f"{t:.4f}" for t in ts)
                      for g, ts in turns.items()))


def compat_checks(dev, root: str) -> None:
    """Compat mode: the 32k exact-IC disk's neighbor tables on the card
    bit-equal to the CPU's, 10 compat steps against the CPU's (counts
    equal, positions rel-L2 <= 1e-6, acc rel-L2 <= 1e-4), the step profiled
    (``utils/profile_step.py --backend compat``), ``run --compat
    --exact-ic`` and ``parity`` on dumps of the CPU's trajectory."""
    from smoothed_particle_hydrodynamics_tpu_torch.compat import golden
    from smoothed_particle_hydrodynamics_tpu_torch.compat.exact_ic import (
        reference_initial_state)
    from smoothed_particle_hydrodynamics_tpu_torch.compat.neighbors import (
        find_neighbors_compat)
    from smoothed_particle_hydrodynamics_tpu_torch.compat.step import (
        compat_density, compat_step)
    from smoothed_particle_hydrodynamics_tpu_torch.config import SphConfig
    from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
    from smoothed_particle_hydrodynamics_tpu_torch.utils import profile_step

    cfg = SphConfig(num_particles=COMPAT_N)
    t0 = time.perf_counter()
    host = reference_initial_state(cfg, device="cpu")
    ic_s = time.perf_counter() - t0
    st = ParticleState(*(t.to(dev) for t in host))
    nb, nb_h = (find_neighbors_compat(cfg, s.position) for s in (st, host))
    check(torch.equal(nb.count.cpu(), nb_h.count)
          and torch.equal(nb.ids.cpu(), nb_h.ids)
          and torch.equal(nb.dists.cpu().view(torch.int32),
                          nb_h.dists.view(torch.int32)),
          "compat: step-0 neighbor ids, counts, dists card != CPU")
    rho, rho_h = compat_density(cfg, st, nb), compat_density(cfg, host, nb_h)
    rho_bits = torch.equal(rho.cpu().view(torch.int32),
                           rho_h.view(torch.int32))
    print(f"[compat] 32k exact-IC disk ({ic_s:.2f} s on the host): step-0 "
          f"neighbor ids, counts and stored distances bit-equal to the CPU's "
          f"(mean {nb.count.float().mean().item():.4f}, max "
          f"{int(nb.count.max())}); rho bit-equal: {rho_bits}")
    traj = [host]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(COMPAT_STEPS):
        st, _ = compat_step(cfg, st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / COMPAT_STEPS
    for _ in range(COMPAT_STEPS):
        traj.append(compat_step(cfg, traj[-1])[0])
    h = traj[-1]
    r_pos = rel_l2(st.position.cpu(), h.position)
    r_acc = rel_l2(st.acceleration.cpu(), h.acceleration)
    counts_eq = torch.equal(st.neighbor_count.cpu(), h.neighbor_count)
    print(f"[compat] {COMPAT_STEPS} compat steps on the card vs the CPU: "
          f"counts_equal={counts_eq} pos_rel_l2={r_pos:.3e} "
          f"acc_rel_l2={r_acc:.3e}; {ms:.3f} ms/step on the card (host "
          f"clock, synchronized)")
    check(counts_eq and r_pos <= 1e-6 and r_acc <= ACC_BAR,
          f"compat steps: counts {counts_eq} pos {r_pos} acc {r_acc}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        profile_step.main(PROFILE_COMPAT)
    prof = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[compat] profile_step {' '.join(PROFILE_COMPAT)}: untraced "
          f"ms/step {[round(x, 4) for x in prof['untraced_ms_per_step']]}, "
          f"traced {prof['traced_ms_per_step']:.4f}, device busy "
          f"{prof['device_busy_ms_per_step']:.4f} ms/step "
          f"({prof['device_busy_share']:.1%}), host aten ops/step "
          f"{prof['host_aten_ops_per_step']:.1f}; top kernels "
          + json.dumps({k[:40]: round(v, 4) for k, v in
                        prof["top_kernels_ms_per_step"].items()}))

    out = f"{root}/compat_run"
    t0 = time.perf_counter()
    rc, text = cli(["run", *CLI_COMPAT, "--out", out, "--quiet"])
    wall = time.perf_counter() - t0
    rows = _jsonl(f"{out}/diagnostics.jsonl")
    meta = json.load(open(f"{out}/run.json"))
    check(rc == 0 and len(rows) == CLI_COMPAT_STEPS
          and meta["backend"] == "compat"
          and meta["config"]["compat"] and all(
              math.isfinite(r["total_energy"]) for r in rows),
          f"cli compat run: exit {rc}, {len(rows)} rows")
    print(f"[compat cli] run {' '.join(CLI_COMPAT)}: {wall:.2f} s, median "
          f"{statistics.median(r['step_ms'] for r in rows):.4f} ms/step; "
          f"neighbor mean {rows[0]['neighbor_mean']:.4f} -> "
          f"{rows[-1]['neighbor_mean']:.4f}")

    # dumps of the CPU's trajectory in tools/golden_main.cpp's format
    gdir = f"{root}/golden"
    os.makedirs(gdir)
    dumps = traj[:4]
    for k, s in enumerate(dumps):
        zeros = np.zeros((s.n, 32), np.float32)
        golden.write_golden(f"{gdir}/state_{k:05d}.bin", golden.GoldenState(
            s.n, s.mass.numpy(), s.density.numpy(), s.position.numpy(),
            s.velocity.numpy(), s.acceleration.numpy(),
            s.neighbor_count.numpy(), zeros.astype(np.uint32), zeros))
    rc, text = cli(["parity", gdir, "--cell-capacity",
                    str(cfg.cell_capacity)])
    print("[compat cli] parity on dumps of the CPU's trajectory: exit "
          f"{rc}\n" + text.replace(gdir + "/", "  ").rstrip())
    check(rc == 0 and "PASS" in text and text.count(
        "neighbor_count_match=1.0000") == len(dumps) - 1,
        f"cli parity: exit {rc}")


def examples_checks(dev, root: str) -> None:
    """The examples under ``SPH_EXAMPLE_QUICK=1`` on the card, in a
    working directory of their own."""
    import runpy

    here, argv = os.getcwd(), sys.argv
    os.environ["SPH_EXAMPLE_QUICK"] = "1"
    try:
        for name in EXAMPLES:
            os.makedirs(f"{root}/{name}")
            os.chdir(f"{root}/{name}")
            sys.argv = [name, *EXAMPLE_ARGS]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                runpy.run_module(f"{PKG.replace('/', '.')}.examples.{name}",
                                 run_name="__main__")
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            want = ("total-energy drift" if name == "quickstart"
                    else "final KE")
            check(want in text, f"example {name}: {text!r}")
            if name == "quickstart":
                check(os.path.getsize("quickstart_final.png") > 0,
                      "quickstart: no PNG")
                check(f"device={dev}" in text, f"quickstart: not on {dev}")
            print(f"[examples] {name} ({wall:.2f} s): "
                  + " | ".join(text.strip().splitlines()))
    finally:
        os.chdir(here)
        sys.argv = argv
        del os.environ["SPH_EXAMPLE_QUICK"]


def slice_phase(dev, ckpt: str | None) -> dict:
    """Phase 17; returns the render ms per frame at 1M."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_p17_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ms = render_checks(dev)
        cli_render_checks(dev, root, ckpt)
        groups_checks(dev)
        compat_checks(dev, root)
        examples_checks(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[p17] phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return ms


# phase 18: the multi-rank work through what a user runs: ``run
# --devices 2`` on the 1M splash (the slab engine with its kernels, exact,
# capped and fused, checkpointed, resumed; the halo-sharded step), one
# step of the halo step, the gather oracle and the single-device step from
# one state, the dry run at 2 and 4 ranks, the distributed example, and
# where the slab step's time goes under gloo's host staging.  On one card
# the ranks are gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
# device).
DEV_N = 1_000_000
# the splash's overrides: bench.py's 1.25h cells, the exact window of the
# single-device main path (capped modes derive theirs)
DEV_SCENE_NAME = "splash"
DEV_SCENE = dict(cell_size_factor=1.25, pallas_window_t=208)
DEV_SLAB = ["--devices", "2", "--partition", "slab", "--backend", "pallas",
            "--rebalance-threshold", "1.5"]
DEV_STEPS, DEV_BLOCK, DEV_RESUME = 20, 10, 10
DEV_HALO_STEPS = 3
DEV_CAPPED = ["--set", "capped_candidates=4", "--set", "pallas_window_t=0"]
# mode -> (flags, the slab kernels' wrappers it launches once a step)
DEV_MODES = {
    "exact": ([], ("density_ext", "force_ext")),
    "capped": (DEV_CAPPED, ("density_ext_capped", "force_ext_capped")),
    "fused": (DEV_CAPPED + ["--set", "capped_fused=true"],
              ("density_sub_pre", "fused_ext")),
}
DEV_DRYRUNS = (2, 4)
# the distributed example at its quick size (4,096 particles): at its own
# 32,768, 8 gloo ranks on one H100 took 79 s
DIST_QUICK = True
STAGING_STEPS = 10


def dev_splash() -> list[str]:
    return ["--scene", DEV_SCENE_NAME, "-n", str(DEV_N)] + [
        a for k, v in DEV_SCENE.items() for a in ("--set", f"{k}={v}")]


@contextlib.contextmanager
def rank_reports():
    """Every ``RankPool`` closed while the context is open reports its
    ranks first (``report``: launch counts, valid rows, live halo rows),
    appended to the yielded list, one list of rank reports per pool."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import comm

    reports = []
    close = comm.RankPool.close

    def closing(self):
        try:
            if self._procs and not getattr(self, "_reporting", False):
                self._reporting = True
                reports.append(self.call("report"))
        finally:
            close(self)

    comm.RankPool.close = closing
    try:
        yield reports
    finally:
        comm.RankPool.close = close


def _step_ms(rows: list[dict], skip: int) -> float:
    """The median ``step_ms`` of a run's rows after the first ``skip``."""
    return statistics.median(r["step_ms"] for r in rows[skip:])


def dev_run(dev, label: str, argv: list[str], out: str, steps: int,
            names: tuple = ()) -> tuple[list[dict], list[dict], str]:
    """One ``run --devices`` through the CLI in this process: exit 0, the
    losses 0 on every row, a finite final state holding every particle,
    and each of ``names`` launched once a step on every rank (no other
    slab kernel).  Returns the rows, the rank reports and stdout."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import make_mesh

    reset_launches()
    with rank_reports() as reps:
        w0 = time.perf_counter()
        rc, text = cli(argv + ["--out", out])
        wall = time.perf_counter() - w0
    check(rc == 0 and len(reps) == 1, f"{label}: exit {rc}")
    ranks = reps[0]
    rows = _jsonl(f"{out}/diagnostics.jsonl")
    meta = json.load(open(f"{out}/run.json"))
    final = np.load(f"{out}/final_state.npz")
    n = meta["config"]["num_particles"]
    losses = {k: sum(r[k] for r in rows) for k in
              ("truncated_ranges", "halo_dropped", "migration_dropped")}
    banner = next((x for x in text.splitlines() if x.startswith("scene=")),
                  "")
    print(f"[devices {label}] {wall:.2f} s: {banner!r}; {len(rows)} rows, "
          f"median {_step_ms(rows, 0):.3f} ms/step; losses {losses}; rows "
          f"per rank {[r['count'] for r in ranks]}; live halo rows (left, "
          f"right) {[r['band_halo'] for r in ranks]}; launches per rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}"
          f"; run.json devices {meta['devices']} comm {meta['comm']}")
    for line in text.splitlines():
        if line.startswith(("derived", "rebalanced", "resumed")):
            print(f"[devices {label}]   {line}")
    check(not any(losses.values()), f"{label}: losses {losses}")
    check(bool(np.isfinite(final["position"]).all()
               and np.isfinite(final["velocity"]).all()
               and (final["mass"] > 0).all())
          and final["position"].shape == (n, 3)
          and sum(r["count"] for r in ranks) == n,
          f"{label}: every particle held once, finite")
    layout = make_mesh(2, dev)
    check(meta["devices"] == list(layout.devices)
          and meta["comm"] == layout.backend,
          f"{label}: placement {meta['devices']} {meta['comm']}")
    # the kernels launch on the card (on the CPU the twins run, uncounted)
    once = steps if dev.type == "cuda" else 0
    for r in ranks:
        got = r["launches"]
        check(all(got[k] == once for k in names)
              and not any(v for k, v in got.items() if k not in names),
              f"{label}: {names} once a step ({steps}), nothing else: {got}")
    return rows, ranks, text


def dev_cli_checks(dev, root: str) -> dict:
    """The ``run --devices 2`` runs: slab exact (timed in turns against
    the single-device ``run``), capped, fused, a resume; then the halo
    partition.  Returns ms/step by run."""
    ms = {}
    single = ["run", *dev_splash(), "--steps",
              str(DEV_STEPS), "--block", str(DEV_BLOCK), "--quiet"]
    turns = []

    def single_turn(tag):
        out = f"{root}/single_{tag}"
        rc, _ = cli(single + ["--out", out])
        check(rc == 0, f"single-device run {tag}: exit {rc}")
        turns.append(("single", _step_ms(_jsonl(f"{out}/diagnostics.jsonl"),
                                         DEV_BLOCK)))

    def argv(flags, tag, steps=DEV_STEPS):
        return ["run", *dev_splash(), *flags, *DEV_SLAB,
                "--steps", str(steps), "--block", str(DEV_BLOCK),
                "--checkpoint-every", str(DEV_BLOCK), "--checkpoint-dir",
                f"{root}/ck_{tag}", "--quiet"]

    single_turn("a")
    for label, (flags, names) in DEV_MODES.items():
        rows, ranks, _ = dev_run(dev, f"slab {label}", argv(flags, label),
                                 f"{root}/{label}", DEV_STEPS, names)
        ms[f"slab {label}"] = _step_ms(rows, DEV_BLOCK)
        if label == "exact":
            turns.append(("slab", ms["slab exact"]))
            # the inner sides' halos were live (rank 0's right, rank 1's
            # left)
            check(ranks[0]["band_halo"][1] > 0 and ranks[1]["band_halo"][0] > 0,
                  f"slab exact: live inner halos {[r['band_halo'] for r in ranks]}")
            rows2, _, _ = dev_run(dev, "slab exact (turn)", argv(flags, "turn"),
                                  f"{root}/turn", DEV_STEPS, names)
            turns.append(("slab", _step_ms(rows2, DEV_BLOCK)))
            single_turn("b")
            print(f"[devices turns] 1M splash exact, ms/step of the second "
                  f"block (diagnostics.jsonl), single-device run then run "
                  f"--devices 2 in turns: {turns}")
            ms["turns"] = turns
    # resume the fused run for 10 more steps
    _, names = DEV_MODES["fused"]
    rows, _, text = dev_run(
        dev, "slab fused resume", ["run", *DEV_SLAB, "--resume",
                              "--checkpoint-dir", f"{root}/ck_fused",
                              "--steps", str(DEV_STEPS + DEV_RESUME),
                              "--block", str(DEV_BLOCK), "--quiet"],
        f"{root}/resume", DEV_RESUME, names)
    check(f"at step {DEV_STEPS}" in text and rows[0]["step"] == DEV_STEPS
          and len(rows) == DEV_RESUME, f"resume: {text!r} {rows[0]['step']}")
    # the halo partition (cell-list sweeps, replicated binning)
    rows, _, _ = dev_run(dev, "halo", ["run", *dev_splash(),
                                  "--devices", "2", "--partition", "halo",
                                  "--steps", str(DEV_HALO_STEPS), "--block",
                                  "1", "--quiet"], f"{root}/halo",
                         DEV_HALO_STEPS)
    ms["halo"] = _step_ms(rows, 1)
    return ms


def dev_library_checks(dev) -> None:
    """One spawn of two ranks from one 1M splash state (``library_rank``):
    one step of the halo step and of the gather oracle at world 2 against
    the single-device cell-list step; then where the slab step's time goes
    under gloo's host staging."""
    from smoothed_particle_hydrodynamics_tpu_torch.models import make_scene
    from smoothed_particle_hydrodynamics_tpu_torch.ops.step import step
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        make_mesh, spawn_ranks)
    from smoothed_particle_hydrodynamics_tpu_torch.state import state_to_numpy

    cfg, st = make_scene(DEV_SCENE_NAME, device=dev, num_particles=DEV_N,
                         **DEV_SCENE)
    layout = make_mesh(2, dev)
    state = state_to_numpy(st)
    jobs = [dict(cfg=cfg, state=state, variant=v) for v in ("halo", "gather")]
    t0 = time.perf_counter()
    outs = spawn_ranks(2, library_rank, jobs, STAGING_STEPS,
                       backend=layout.backend, devices=list(layout.devices),
                       timeout_s=600.0, threads=layout.threads)
    wall = time.perf_counter() - t0
    sharded = [o["sharded"] for o in outs]
    one, d1 = step(cfg, st, backend="celllist")
    check(all((o[0]["order"] == sharded[0][0]["order"]).all()
              for o in sharded), "sharded: every rank sorts alike")
    ke1 = float(d1.kinetic_energy)
    for i, v in enumerate(("halo", "gather")):
        s, d = sharded[0][i]["state"], sharded[0][i]["diags"]
        nc_eq = bool((torch.from_numpy(s["neighbor_count"])
                      == one.neighbor_count.cpu()).all())
        r_rho = rel_l2(torch.from_numpy(s["density"]), one.density.cpu())
        r_pos = rel_l2(torch.from_numpy(s["position"]), one.position.cpu())
        r_vel = rel_l2(torch.from_numpy(s["velocity"]), one.velocity.cpu())
        ke = float(d["kinetic_energy"][0])
        print(f"[devices three-way 1M] {v} at world 2 ({layout.describe()}) "
              f"vs the single-device celllist step: counts equal {nc_eq}, "
              f"rho rel_l2 {r_rho:.3e}, position rel_l2 {r_pos:.3e}, "
              f"velocity rel_l2 {r_vel:.3e}, KE {ke} vs {ke1}; halo_dropped "
              f"{int(d['halo_dropped'][0])} truncated "
              f"{int(d['truncated_ranges'][0])} vs "
              f"{int(d1.truncated_ranges)}; spawn + 2 steps + staging "
              f"{wall:.2f} s")
        check(nc_eq and r_rho <= 1e-6 and r_pos <= 1e-6 and r_vel <= 1e-6
              and abs(ke - ke1) <= 1e-5 * max(abs(ke1), 1e-30)
              and int(d["halo_dropped"][0]) == 0,
              f"three-way {v}: counts {nc_eq} rho {r_rho} pos {r_pos} vel "
              f"{r_vel} KE {ke} vs {ke1}")
    for r, o in enumerate(outs):
        o = o["staging"]
        print(f"[devices staging] rank {r} ({layout.describe()}, staged "
              f"{o['staged']}): slab exact 1M {o['plain_ms']:.3f} ms/step "
              f"plain; {o['traced_ms']:.3f} ms/step with the collectives "
              f"timed, of which {o['comm_ms']:.3f} ms inside collectives "
              f"({o['comm_ms'] / o['traced_ms']:.1%}) and {o['copy_ms']:.3f} "
              f"ms in their device-host copies "
              f"({o['copy_ms'] / o['traced_ms']:.1%})")


def dev_dryruns(dev) -> None:
    from smoothed_particle_hydrodynamics_tpu_torch import graft_entry

    for n in DEV_DRYRUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = graft_entry.dryrun_multichip(n, dev)
        text = buf.getvalue().strip().splitlines()
        print(f"[devices dryrun {n}] ({time.perf_counter() - t0:.2f} s) "
              + " | ".join(text) + f"; rank 0 launches "
              f"{ {k: v for k, v in res['launches'].items() if v} }")
        check(text[-1].startswith(f"dryrun_multichip({n}): ok"),
              f"dryrun {n}: {text}")
        if dev.type == "cuda":
            check(all(res["launches"][k] == 2 for k in (
                "density_ext", "force_ext", "density_ext_capped",
                "force_ext_capped")), f"dryrun {n}: kernels {res['launches']}")


def dev_example(dev, root: str) -> None:
    """``examples/distributed.py`` as a user runs it (its own size unless
    ``DIST_QUICK``)."""
    import runpy

    here, argv = os.getcwd(), sys.argv
    os.makedirs(f"{root}/distributed")
    if DIST_QUICK:
        os.environ["SPH_EXAMPLE_QUICK"] = "1"
    try:
        os.chdir(f"{root}/distributed")
        sys.argv = ["distributed", *EXAMPLE_ARGS]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            runpy.run_module(f"{PKG}.examples.distributed".replace("/", "."),
                             run_name="__main__")
        text = buf.getvalue()
    finally:
        os.chdir(here)
        sys.argv = argv
        os.environ.pop("SPH_EXAMPLE_QUICK", None)
    print(f"[devices example] distributed ({time.perf_counter() - t0:.2f} s):"
          " " + " | ".join(text.strip().splitlines()))
    check("all particles accounted for" in text
          and "migration_dropped=0" in text, f"example: {text!r}")


def library_rank(group, jobs: list[dict], n_steps: int) -> dict:
    """One rank of phase 18's library checks: the sharded steps of
    ``jobs`` (``sharding.run_sharded_jobs``), then the staging measurement
    (``staging_rank``, ``n_steps`` steps) from the first job's state."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import sharding
    from smoothed_particle_hydrodynamics_tpu_torch.state import (
        state_from_numpy)

    sharded = sharding.run_sharded_jobs(group, jobs)
    st = state_from_numpy(jobs[0]["state"], group.device)
    return dict(sharded=sharded,
                staging=staging_rank(group, jobs[0]["cfg"], st, n_steps))


def staging_rank(group, cfg, st, n_steps: int) -> dict:
    """One rank of the staging measurement: the slab exact step on ``st``,
    timed plain (``n_steps`` steps after 3 warmup steps), then with every
    collective and every host copy of the group timed (device synchronised
    around each): ms per step and the time inside the collectives and
    inside their device-host copies."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs

    dev = group.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (
        lambda: None)
    zsplit = slabs.derive_zsplit(cfg, st, group.world)
    caps = slabs.derive_slab_caps(cfg, st, group.world, zsplit=zsplit)
    carry = slabs.distribute(cfg, st, group, caps[0], zsplit)
    step = slabs.make_slab_step(cfg, group, *caps, zsplit=zsplit,
                                sweeps="pallas")
    for _ in range(3):
        carry, _ = step(carry)

    def steps():
        nonlocal carry
        sync()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            carry, _ = step(carry)
        sync()
        return (time.perf_counter() - t0) * 1e3 / n_steps

    plain = steps()
    spent = {"comm": 0.0, "copy": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            spent[key] += time.perf_counter() - t0
            return out
        return run

    for name, key in (("_ring", "comm"), ("_reduce", "comm"),
                      ("all_gather", "comm"), ("_out", "copy"),
                      ("_back", "copy")):
        setattr(group, name, timed(getattr(group, name), key))
    traced = steps()
    per = {k: v * 1e3 / n_steps for k, v in spent.items()}
    return dict(plain_ms=plain, traced_ms=traced, comm_ms=per["comm"],
                copy_ms=per["copy"], staged=group._staged,
                caps=caps, backend=group.backend)


def dev_nccl(dev, root: str) -> None:
    """``run --devices 2`` on NCCL needs two cards."""
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < 2:
        print(f"[devices nccl] NCCL at --devices 2: not run ({cards} card"
              f"{'s' if cards != 1 else ''}; NCCL refuses two ranks on one "
              "device); not counted as a pass")
        return
    _, names = DEV_MODES["exact"]
    dev_run(dev, "slab exact nccl", ["run", *dev_splash(), *DEV_SLAB,
                                     "--steps", "4", "--block", "2",
                                     "--quiet"], f"{root}/nccl", 4, names)


def devices_phase(dev) -> dict:
    """Phase 18; returns ms/step by run."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_p18_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ms = dev_cli_checks(dev, root)
        dev_library_checks(dev)
        dev_dryruns(dev)
        dev_example(dev, root)
        dev_nccl(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[devices] ms/step: {ms}")
    print(f"[p18] phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return ms


# phase 19: the study and profiling tools (``tools/``), each through its
# ``main`` as ``python -m ...tools.<name>`` runs it, on the card: the capped
# full-run record at full duration held to the JAX record's envelopes, the
# capped density noise at 1M, the drift trace and the engines' A/B for 24
# steps, each profile tool once at 1M, the dial A/B with two variants for
# two rounds, and the primitive ops, each against numpy.
TOOLS_STEPS = 24
TOOLS_DIALS = ("baseline", "block256")
TOOLS_DIAL_ROUNDS, TOOLS_DIAL_BLOCK = 2, 10
# the cell-list profile at 1M (the disk's own size is 32,768): its phases
# take ~1 s a call there, so few calls
TOOLS_PROFILE_STEP_N, TOOLS_PROFILE_STEP_ITERS = 1_000_000, 2
# the sweeps' wrappers a capped full run launches (exact and capped K_c 4)
FULLRUN_WRAPPERS = ("density_t", "force_t", "density_capped_t",
                    "force_capped_t")


def tools_fullrun(dev, out: str) -> dict:
    """``tools/capped_fullrun`` at full duration: the envelopes, the K1/K2
    launches of its runs, each row's ms/step."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
    from smoothed_particle_hydrodynamics_tpu_torch.tools import capped_fullrun

    reset_launches()
    rec = capped_fullrun.main(device=dev, out=out)
    check(not rec["smoke"] and rec["steps_scale"] >= 1.0,
          "capped_fullrun: a full-duration record")
    check(rec["rows"]["disk_32k"]["steps"] >= 1001
          and rec["rows"]["splash_1m"]["steps"] >= 1000,
          "capped_fullrun: 1,001 disk and 1,000 splash steps")
    bad = capped_fullrun.envelope_failures(rec["rows"])
    for name, row in rec["rows"].items():
        print(f"[tools] capped_fullrun {name}: exact "
              f"{row['exact']['ms_per_step']:.4f} ms/step, capped "
              f"{row['capped_k4']['ms_per_step']:.4f} ms/step; KE tail ratio "
              f"{row['ke_tail_ratio']:.4f}, drift exact "
              f"{row['exact']['energy_drift']:.4f} capped "
              f"{row['capped_k4']['energy_drift']:.4f}, density ratios "
              f"{row['density_ratio_t0']:.5f} / "
              f"{row['density_ratio_end']:.5f}, cap binds {row['cap_binds']}, "
              f"truncated {row['capped_k4']['truncated_ranges_max']}")
    check(not bad, f"capped_fullrun envelopes: {bad}")
    for name in FULLRUN_WRAPPERS:
        n = getattr(sweeps_t, name).launches
        check(n > 0, f"capped_fullrun: {name} launched")
        print(f"[tools] capped_fullrun: {name} {n} launches")
    return rec


def tools_checks(dev) -> dict:
    """The other eleven tools; returns what each measured."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        ab_dials, ab_engines, ab_slab, capped_noise, microbench,
        profile_lazy, profile_pallas, profile_prepare, profile_slab,
        profile_step, trace_drift)

    def times_ok(label, ms):
        vals = list(ms.values()) if isinstance(ms, dict) else list(ms)
        check(all(math.isfinite(v) and v > 0 for v in vals),
              f"{label}: every time finite and positive")

    out = {}
    t = time.perf_counter()
    r = capped_noise.main(device=dev)
    check(0.0 < r["rel_l2"] < 1.0 and abs(r["mean_ratio"] - 1.0) < 0.01,
          f"capped_noise: rel-L2 in (0, 1), mean ratio within 1 %: {r}")
    out["capped_noise"] = r
    print(f"[tools] capped_noise {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    r = trace_drift.main(steps=TOOLS_STEPS, device=dev)
    check(len(r["times_ms"]) == TOOLS_STEPS, "trace_drift: every step")
    times_ok("trace_drift", r["times_ms"])
    check(all(math.isfinite(d) for d in r["drift_over_skin"]),
          "trace_drift: finite drift")
    out["trace_drift"] = {k: r[k] for k in ("steady_ms", "rebin_ms", "skin")}
    out["trace_drift"]["rebins"] = int(sum(r["rebinned"]))
    print(f"[tools] trace_drift {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    r = ab_engines.main(steps=TOOLS_STEPS, device=dev)
    rel = r["rel_l2"]
    first = (r["rebinned_single"].index(True)
             if True in r["rebinned_single"] else len(rel))
    check(all(math.isfinite(x) for x in rel), "ab_engines: finite rel-L2")
    check(max(rel[:first]) <= 1e-5,
          f"ab_engines: rel-L2 <= 1e-5 before the first rebin: {rel[:first]}")
    out["ab_engines"] = dict(first_rebin=first, rel_l2_last=rel[-1],
                             rel_l2_before_rebin=max(rel[:first]))
    print(f"[tools] ab_engines {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    r = profile_pallas.main(device=dev)
    times_ok("profile_pallas", r["ms"])
    out["profile_pallas"] = r["ms"]
    r = profile_prepare.main(device=dev)
    times_ok("profile_prepare", r["ms"])
    want = sweeps_t.prepare_t(r["cfg"], r["state"])
    for f in want._fields:
        a, b = getattr(r["composed"], f), getattr(want, f)
        check((a is None and b is None) or torch.equal(a, b),
              f"profile_prepare: composed {f} bit-equal to prepare_t's")
    out["profile_prepare"] = r["ms"]
    r = profile_lazy.main(device=dev)
    times_ok("profile_lazy", [v[0] for v in r["steady_rebin_ms"].values()])
    out["profile_lazy"] = r["steady_rebin_ms"]
    r = profile_slab.main(phases=True, device=dev)
    times_ok("profile_slab", [v[0] for v in r["steady_rebin_ms"].values()])
    out["profile_slab"] = r["steady_rebin_ms"]
    r = profile_step.main(TOOLS_PROFILE_STEP_N, device=dev,
                          iters=TOOLS_PROFILE_STEP_ITERS)
    times_ok("profile_step", r["ms"])
    out["profile_step"] = r["ms"]
    print(f"[tools] profile tools {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    r = ab_dials.main(rounds=TOOLS_DIAL_ROUNDS, block=TOOLS_DIAL_BLOCK,
                      only=list(TOOLS_DIALS), device=dev)
    check(sorted(r) == sorted(TOOLS_DIALS), "ab_dials: both variants")
    check(all(math.isfinite(v["fp"]) and v["steps"] == TOOLS_DIAL_ROUNDS
              * TOOLS_DIAL_BLOCK for v in r.values()),
          "ab_dials: finite fingerprints, every step")
    out["ab_dials"] = r
    r = ab_slab.main(rounds=1, block_calls=2, only=["baseline"], device=dev)
    check(list(r) == ["baseline"] and math.isfinite(r["baseline"]["fp"]),
          "ab_slab: the baseline built and stepped")
    out["ab_slab"] = r
    print(f"[tools] A/B tools {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    out["microbench"] = microbench.main(device=dev)
    for label, call, ref in microbench.ops(dev):
        check(np.array_equal(call().cpu().numpy(), ref()),
              f"microbench: {label} equals numpy's")
    print(f"[tools] microbench {time.perf_counter() - t:.1f} s")
    return out


# the probes' runs in phase 19: the floor probe at its default (1M exact)
# and at K_c 4; probe_scan at its default (the 32k disk) and on the 1M
# splash, as the JAX tool's docstring runs it; the other three at their
# defaults
FLOOR_K_CS = (0, 4)
SCAN_CASES = ((32_768, "disk"), (1_000_000, "splash"))
# the tally's formulations against kdk_integrate's: f32 sums of 1M terms in
# other orders, |L| over terms of both signs
TALLY_BAR = 1e-4


def tools_probes(dev) -> dict:
    """The five probes through their mains; returns what each measured and
    ``floor_launches``, each floor kernel's launches in the floor probe's
    runs (launch counters reset just before)."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        probe_cond, probe_dispatch, probe_dma_floor, probe_scan, probe_tally)

    def finite_ms(label, vals):
        check(all(math.isfinite(v) and v > 0 for v in vals),
              f"{label}: every time finite and positive")

    out = {}
    t = time.perf_counter()
    reset_launches()
    for k_c in FLOOR_K_CS:
        r = probe_dma_floor.main(k_c=k_c, device=dev)
        finite_ms(f"probe_dma_floor K_c={k_c}",
                  [v["ms"] for v in r["rows"].values()]
                  + list(r["real"].values()))
        out[f"probe_dma_floor K_c={k_c}"] = {
            k: r[k] for k in ("rows", "decomposition", "real", "volume")}
    floor = {name: wrapper(name).launches for name in FLOOR_KERNELS}
    for name, count in floor.items():
        check(count > 0, f"probe_dma_floor: {name} launched")
    print(f"[tools] probe_dma_floor {time.perf_counter() - t:.1f} s, "
          f"launches {floor}")

    t = time.perf_counter()
    r = probe_cond.main(device=dev)
    finite_ms("probe_cond", list(r["median"].values()))
    out["probe_cond"] = r
    for n, scene in SCAN_CASES:
        r = probe_scan.main(n, scene, device=dev)
        finite_ms(f"probe_scan {scene}", list(r["ms"].values()))
        out[f"probe_scan {scene}"] = r
    print(f"[tools] probe_cond, probe_scan {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    r = probe_dispatch.main(device=dev)
    finite_ms("probe_dispatch", list(r["ms"].values()))
    out["probe_dispatch"] = r["ms"]
    r = probe_tally.main(device=dev)
    finite_ms("probe_tally", list(r["ms"].values()))
    ref = np.asarray(r["values"]["kdk production (reference point)"])
    for name, vals in r["values"].items():
        err = np.abs(np.asarray(vals) - ref) / np.maximum(np.abs(ref), 1e-30)
        check(bool((err <= TALLY_BAR).all()),
              f"probe_tally: {name} (KE, PE, |L|) within rel {TALLY_BAR} of "
              f"kdk_integrate's: {vals} vs {ref.tolist()}")
    out["probe_tally"] = r["ms"]
    print(f"[tools] probe_dispatch, probe_tally "
          f"{time.perf_counter() - t:.1f} s")
    return dict(probes=out, floor_launches=floor)


# phase 19's run of the strong-scaling projection: one size (125k a card of
# an 8-card run, grid_nz 16) and both of bench.py's slab rows
PROJECTION_SIZES, PROJECTION_CHIPS = "125000", 8
PROJECTION_ROWS = "slab_1dev,slab_capped_k4"
PROJECTION_TIMEOUT_S = 300.0


def tools_projection(dev, root: str) -> dict:
    """``tools/scale_projection`` at ``PROJECTION_SIZES``: every row
    measured in its own process, none lost a particle or a candidate, every
    time finite, the modeled hop in each row."""
    from smoothed_particle_hydrodynamics_tpu_torch.tools import (
        scale_projection)

    t = time.perf_counter()
    doc = scale_projection.main(
        sizes=PROJECTION_SIZES, chips=PROJECTION_CHIPS, rows=PROJECTION_ROWS,
        out=os.path.join(root, "scale_projection.json"), device=dev,
        timeout=PROJECTION_TIMEOUT_S)
    want = len(PROJECTION_SIZES.split(",")) * len(PROJECTION_ROWS.split(","))
    check(not doc["failed"] and len(doc["rows"]) == want,
          f"scale_projection: {want} rows measured, failed {doc['failed']}")
    link = f"projected_pps_x{PROJECTION_CHIPS}_with_link"
    for r in doc["rows"]:
        check(scale_projection.lossless(r),
              f"scale_projection {r['row']} @ {r['n_per_chip']}: no drop, "
              f"no truncation, finite: {r}")
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in (
            "ms_per_step", "link_ms_per_step", "ms_per_step_with_link",
            link)), f"scale_projection {r['row']}: finite times")
        print(f"[tools] scale_projection {r['row']} @ {r['n_per_chip']}: "
              f"{r['ms_per_step']:.4f} ms/step, with link "
              f"{r['ms_per_step_with_link']:.4f}, rebins {r['rebins']}, "
              f"h_cap {r['h_cap']}, window {r['window_t']}")
    print(f"[tools] scale_projection {time.perf_counter() - t:.1f} s")
    return doc


def tools_phase(dev, fullrun_out: str | None = None) -> dict:
    """Phase 19; returns the full-run record, the tools' and the probes'
    readings and the floor kernels' launches (``tools_probes``).
    ``fullrun_out`` keeps the full-run record (default: a temporary file
    beside the script, removed)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_p19_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        rec = tools_fullrun(dev, fullrun_out
                            or os.path.join(root, "capped_fullrun.json"))
        print(f"[tools] capped_fullrun {time.perf_counter() - t_phase:.1f} s")
        out = tools_checks(dev)
        probes = tools_probes(dev)
        out["scale_projection"] = tools_projection(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[p19] phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return dict(fullrun=rec, tools=out, **probes)


# phase 20: the single-card 10M configurations through the port's entry
# points.  bench.py's capped_k4_10m row (bench.py:133-145: 8 steps after 3
# warmup) and the 10M dam break at the settings `python bench.py --scene
# dam_break_10m -n 10000000` gives it (bench.py:223-229, with its 50 steps
# after 5 warmup): name -> (scene, config overrides, bench arguments, the
# step kernels it runs: K1 and K2 in KERNELS)
TENM_N = 10_000_000
TENM = {
    "capped_k4_10m": ("splash", dict(
        num_particles=TENM_N, cell_size_factor=1.25, capped_candidates=4,
        pallas_window_t=0, pallas_block_t=256),
        ["--steps", "8", "--warmup", "3"],
        ("density_band_t<capped>", "force_band_t<capped>")),
    "dam_break_10m": ("dam_break_10m", dict(
        num_particles=TENM_N, cell_size_factor=1.25, pallas_window_t=208),
        ["--steps", "50", "--warmup", "5"], ("density_band_t", "force_band_t")),
}


def peak_gb(dev) -> float:
    """``torch.cuda.max_memory_allocated`` in GB (0 on the CPU)."""
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def tenm_vs_twins(dev, name: str) -> dict:
    """K1 and K2 of ``TENM[name]``'s first state (its sweep settings
    resolved as ``bench`` resolves them) against their twins over every
    row: counts equal, rho rel-L2 <= 1e-6, acc rel-L2 <= 1e-4, every
    output finite."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_scene)

    t0 = time.perf_counter()
    reset_peak(dev)
    scene, ov, _, (k1, k2) = TENM[name]
    cfg, state = resolve_scene(scene, dev, ov, backend="pallas")
    p = sw.prepare_t(cfg, state)
    del state
    label = f"10M {name}"
    if cfg.capped_candidates:
        pos_c, vel_c = sw.gather_sub_pv(p)
        args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.cell_start, pos_c,
                  p.wm_sub, p.sub_perm)
        twin_d = args_d
        rho_k, nc_k = sw.density_capped_t(*args_d)
        cand = sw.fused_cand_cols(cfg, pos_c, vel_c, rho_k[p.sub_perm],
                                  p.wm_sub)
        args_f = (cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.cell_start,
                  p.sub_perm)
        acc_k = sw.force_capped_t(*args_f)
        frame = (f"sub frame {p.sub_perm.shape[0]} rows, kept "
                 f"{int((p.cand_cid >= 0).sum())}, sub_dropped "
                 f"{int(p.sub_dropped)}")
        check(int(p.sub_dropped) == 0, f"{label}: sub_dropped 0")
    else:
        args_d = (cfg, p.pos_s, p.mass_s, p.cid, p.cell_start)
        twin_d = (*args_d, p.pos_s, p.mass_s)
        rho_k, nc_k = sw.density_t(*args_d)
        cand = sw.fused_cand_cols(cfg, p.pos_s, p.vel_s, rho_k, p.mass_s)
        args_f = (cfg, p.pos_s, p.vel_s, rho_k, cand, p.cid, p.cell_start)
        acc_k = sw.force_t(*args_f)
        frame = "no sub frame (exact)"
    torch.cuda.synchronize()
    t_kernels = time.perf_counter() - t0
    rho_p, nc_p = sw.density_t_plain(*twin_d)
    acc_p = sw.force_t_plain(*args_f)
    torch.cuda.synchronize()
    a, e = sw.band_ranges(cfg, p.cid, p.cell_start)
    widest = int((e - a).clamp(min=0).max())
    print(f"[{label}] n={p.pos_s.shape[0]} grid {cfg.grid_nx}x{cfg.grid_ny}"
          f"x{cfg.grid_nz} window={cfg.pallas_window_t} "
          f"block={cfg.pallas_block_t} capped_sub_len={cfg.capped_sub_len} "
          f"{frame}; widest band {widest} rows; twins over all rows")
    del a, e
    fin = all(bool(torch.isfinite(x).all()) for x in (rho_k, acc_k))
    check(fin, f"{label}: K1 and K2 outputs finite")
    errs = {k1: agree(label, k1, rho_k, rho_p, (nc_k, nc_p)),
            k2: agree(label, k2, acc_k, acc_p, bar=ACC_BAR)}
    t_twins, peak = time.perf_counter() - t0 - t_kernels, peak_gb(dev)
    del rho_p, nc_p, acc_p
    rows = rows_tested_vs_twin(cfg, p, p.pos_s.shape[0] if p.sub_perm is None
                               else p.sub_perm.shape[0], label)
    out = dict(errs=errs, rows_tested=rows, kernels_s=t_kernels,
               twins_s=t_twins, peak_gb=peak, window_t=cfg.pallas_window_t,
               capped_sub_len=cfg.capped_sub_len)
    print(f"[{label}] state, prepare_t and kernels {out['kernels_s']:.1f} s, "
          f"twins {out['twins_s']:.1f} s, peak allocated "
          f"{out['peak_gb']:.3f} GB")
    return out


def tenm_bench(dev, name: str) -> dict:
    """``bench`` on ``TENM[name]`` through the CLI, its K1/K2 counted from 0:
    ms/step, rebins and ``truncated_ranges`` (0 in every step), the window,
    block and sub frame, the peak allocated memory; every value finite."""
    scene, ov, extra, kernels = TENM[name]
    argv = ["bench", "--scene", scene, "-n", str(ov["num_particles"]),
            "--backend", "pallas", "--lazy", *extra]
    for k, v in ov.items():
        if k != "num_particles":
            argv += ["--set", f"{k}={json.dumps(v)}"]
    label = f"10M {name}"
    reset_peak(dev)
    reset_launches()
    t0 = time.perf_counter()
    rc, text = cli(argv)
    wall = time.perf_counter() - t0
    r = json.loads(text.strip().splitlines()[-1])
    counts = {k: wrapper(k).launches for k in kernels}
    steps = r["steps"] + r["warmup_steps"]
    trunc = max(r["truncated_ranges"])
    out = dict(ms_per_step=r["ms_per_step"], steps=r["steps"],
               warmup_steps=r["warmup_steps"], rebins=r["rebins"],
               truncated_ranges=trunc, window_t=r["window_t"],
               block_t=r["block_t"], capped_sub_len=r["capped_sub_len"],
               peak_gb=peak_gb(dev), launches=counts, wall_s=wall,
               finite=r["finite"])
    print(f"[{label}] bench {' '.join(argv[1:])}: rc={rc} "
          f"{out['ms_per_step']:.4f} ms/step over {r['steps']} steps after "
          f"{r['warmup_steps']} warmup, rebins {out['rebins']}, "
          f"truncated_ranges max {trunc}, window {out['window_t']}, block "
          f"{out['block_t']}, capped_sub_len (sub frame) "
          f"{out['capped_sub_len']}, peak allocated {out['peak_gb']:.3f} GB, "
          f"launches {counts}, finite={r['finite']}, {wall:.1f} s")
    check(rc == 0 and r["num_particles"] == ov["num_particles"],
          f"{label}: bench ran at {ov['num_particles']}")
    check(r["finite"] and math.isfinite(out["ms_per_step"])
          and out["ms_per_step"] > 0 and all(
              math.isfinite(x) for x in r["kinetic_energy"]),
          f"{label}: finite state, energies and ms/step")
    check(trunc == 0, f"{label}: truncated_ranges 0 in every step")
    for k, n in counts.items():
        check(n == steps, f"{label}: {k} launched {n} times in {steps} steps")
    return out


def tenm_phase(dev) -> dict:
    """Phase 20: each 10M configuration's kernels against their twins on its
    first state, then its ``bench`` loop."""
    t_phase = time.perf_counter()
    out = {}
    for name in TENM:
        out[name] = dict(twins=tenm_vs_twins(dev, name),
                         bench=tenm_bench(dev, name))
    print(f"[p20] phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 21: the integrator's kernel (csrc/integrate_t.cu, no TPU kernel: the
# JAX integrator is plain jnp) against its twin on the first lazy-step input
# of the benchmark's two cells, at their settings (no closing kick, the box,
# G M = 0), and on the same input with the gravity kick and a central mass
INTEGRATE = {"splash_1m": ("splash", MAIN),
             "dam_break_10m": TENM["dam_break_10m"][:2]}
# bytes a row must move: x, v, a, m read (40 B), x, v written (24 B)
INTEGRATE_ROW_BYTES = 64
# where the twin's tally term equals the float64 sum exactly, the kernel's
# may be this far from it, relative; elsewhere twice the twin's distance or
# one float32 ulp of the sum, whichever is larger: the kernel rounds its
# float64 sum to float32 once, so an exact kernel may sit half an ulp off
# where the twin's float32 sum happened to land nearer
TALLY_EXACT_BAR = 1e-6
TALLY_TERMS = ("KE", "PE", "Lx", "Ly", "Lz", "|L|")


def integrate_inputs(dev, name: str):
    """(cfg, state, acceleration) of ``INTEGRATE[name]``'s first lazy step:
    the sorted state ``init_lazy`` bins, with the density and counts of its
    sweeps, and the acceleration ``sweeps_sorted`` gives it."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.state import ParticleState
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_scene)

    scene, ov = INTEGRATE[name]
    cfg, state = resolve_scene(scene, dev, ov, backend="pallas")
    p = sw.prepare_t(cfg, state)
    del state
    acc, rho, ncount = sw.sweeps_sorted(cfg, p)
    return cfg, ParticleState(p.pos_s, p.vel_s, p.mass_s, rho,
                              torch.zeros_like(p.pos_s), ncount), acc


def rows_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose float32 bits differ, a NaN against a NaN counted
    equal (a NaN's payload carries no value)."""
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    return int((~same).sum())


def tally_errors(cfg, kernel: torch.Tensor, twin: torch.Tensor,
                 terms: torch.Tensor) -> dict:
    """Per tally term (``TALLY_TERMS``): the kernel's and the twin's
    distance from ``terms``' float64 sum, and whether the kernel's is at
    most twice the twin's or one float32 ulp of the sum
    (``TALLY_EXACT_BAR`` relative where the twin's is 0; both NaN where the
    sum is NaN, equal where it is infinite)."""
    s = terms.sum(0)
    ref = [s[0], -s[1], s[2], s[3], s[4],
           torch.zeros_like(s[0]) if cfg.compat else s[2:5].norm()]
    out = {}
    for j, name in enumerate(TALLY_TERMS):
        r, k, t = float(ref[j]), float(kernel[j]), float(twin[j])
        dk, dt = abs(k - r), abs(t - r)
        if math.isnan(r) or math.isinf(r):
            ok = (math.isnan(k) and math.isnan(t)) if math.isnan(r) else (
                k == r)
        elif dt == 0.0:
            ok = dk <= TALLY_EXACT_BAR * abs(r)
        else:
            ok = dk <= max(2.0 * dt, float(np.spacing(np.float32(abs(r)))))
        out[name] = dict(ref=r, kernel=k, twin=t, kernel_dist=dk,
                         twin_dist=dt, ok=ok)
    return out


def integrate_vs_twin(label: str, cfg, state, acc) -> dict:
    """``integrate_t`` against ``kdk_integrate_plain`` on the same input:
    positions and velocities bit-equal, each tally term within
    ``tally_errors``' bar, and a second call's tally bit-equal to the
    first's."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops.integrate import (
        integrate_t, kdk_integrate_plain, tally_terms)

    def vec(t):
        return torch.stack([t.kinetic, t.potential, *t.l_vec,
                            t.angular_momentum])

    new, t1 = integrate_t(cfg, state, acc)
    _, t2 = integrate_t(cfg, state, acc)
    twin, tt = kdk_integrate_plain(cfg, state, acc)
    k1, k2 = vec(t1), vec(t2)
    pos_diff = rows_differ(new.position, twin.position)
    vel_diff = rows_differ(new.velocity, twin.velocity)
    errs = tally_errors(cfg, k1, vec(tt), tally_terms(
        cfg, twin.position, twin.velocity, state.mass).double())
    det = rows_differ(k1, k2) == 0
    print(f"[integrate {label}] n={state.n} kick={cfg.second_kick} "
          f"boundary={cfg.boundary} compat={cfg.compat}: position elements "
          f"differing {pos_diff}, velocity {vel_diff}; tally kernel/twin "
          "distance from the f64 sum: " + ", ".join(
              f"{k} {e['kernel_dist']:.3e}/{e['twin_dist']:.3e}"
              for k, e in errs.items()) + f"; two calls' tallies equal {det}")
    check(pos_diff == 0, f"{label}: positions bit-equal to the twin")
    check(vel_diff == 0, f"{label}: velocities bit-equal to the twin")
    for k, e in errs.items():
        check(e["ok"], f"{label}: tally {k} {e}")
    check(det, f"{label}: two calls' tallies bit-equal")
    return dict(position_differ=pos_diff, velocity_differ=vel_diff,
                tally=errs)


def integrate_phase(dev) -> dict:
    """Phase 21: the integrator's kernel against its twin on each
    ``INTEGRATE`` input (the cell's settings, then the gravity kick with a
    central mass), then its time and the twin's (queued CUDA events) beside
    its bound, ``INTEGRATE_ROW_BYTES`` a row at the HBM rate."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops.integrate import (
        integrate_t, kdk_integrate_plain)

    t_phase = time.perf_counter()
    out = {}
    for name in INTEGRATE:
        reset_peak(dev)
        cfg, st, acc = integrate_inputs(dev, name)
        grav = cfg.replace(second_kick="gravity", central_mass=1.0)
        rec = dict(cell=integrate_vs_twin(name, cfg, st, acc),
                   gravity=integrate_vs_twin(f"{name} gravity", grav, st,
                                             acc))
        launches = integrate_t.launches
        rec.update(
            n=st.n,
            ms=time_ms(lambda: integrate_t(cfg, st, acc), iters=20,
                       warmup=3),
            plain_ms=time_ms(lambda: kdk_integrate_plain(cfg, st, acc),
                             iters=5, warmup=1),
            bound_ms=INTEGRATE_ROW_BYTES * st.n / HBM_BYTES_PER_S * 1e3,
            peak_gb=peak_gb(dev))
        check(integrate_t.launches > launches, f"{name}: integrate_t timed")
        print(f"[integrate {name}] kernel {rec['ms']:.4f} ms, twin "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"(bytes: {INTEGRATE_ROW_BYTES} B a row), "
              f"{rec['bound_ms'] / rec['ms']:.0%} of it; peak allocated "
              f"{rec['peak_gb']:.3f} GB")
        out[name] = rec
        del st, acc
    print(f"[p21] phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 22: K2's candidate columns (csrc/cand_cols_t.cu, no TPU kernel: XLA
# fuses the JAX fused_cand_cols) against their twin on the first step's K2
# input of the benchmark's three cells, and on a one-rank slab frame's
# column views; then a profiled lazy solve of each configuration
CAND = {"splash_1m": ("splash", MAIN),
        "dam_break_10m": TENM["dam_break_10m"][:2],
        "capped_k4_10m": TENM["capped_k4_10m"][:2]}
# bytes a row must move: x, v, rho, m read (32 B), 9 columns written (36 B);
# indexed, the 32-byte sectors of x, v and rho the index touches instead
CAND_ROW_BYTES = 68
# the main path (phases 10 and 14) whose launches of cand_cols_t each
# input's record in the kernels line reports
CAND_PATH = {"splash_1m": "exact", "dam_break_10m": "exact",
             "capped_k4_10m": "capped", "slab_1m": "slab exact"}
CAND_STEPS = 5      # steps of each counted solve
CAND_SLAB_N = MAIN["num_particles"]


def cand_inputs(dev, name: str):
    """(cfg, (pos, vel, rho, mass), index) of ``CAND[name]``'s first K2
    columns: the frame ``prepare_t`` sorts, K1's densities, the sorted
    masses (exact) or the sub frame's reweighted ones and ``sub_perm``
    (capped)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_scene)

    scene, ov = CAND[name]
    cfg, state = resolve_scene(scene, dev, ov, backend="pallas")
    p = sw.prepare_t(cfg, state)
    del state
    rho, _ = sw.density_sweep_t(cfg, p)
    if cfg.capped_candidates:
        return cfg, (p.pos_s, p.vel_s, rho, p.wm_sub), p.sub_perm
    return cfg, (p.pos_s, p.vel_s, rho, p.mass_s), None


def cand_twin(cfg, pos, vel, rho, mass, index=None) -> torch.Tensor:
    """The twin's columns of the same candidates (gathered first where
    ``index`` is given)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    if index is not None:
        rows = index.long()
        pos, vel, rho = pos[rows], vel[rows], rho[rows]
    return sw.fused_cand_cols_plain(cfg, pos, vel, rho, mass)


def cand_vs_twin(label: str, cfg, pos, vel, rho, mass, index=None) -> int:
    """``cand_cols_t`` (``fused_cand_cols`` on the card) against its twin
    on the same inputs: every column bit-equal (a NaN against a NaN counted
    equal); returns the elements that differ."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    launches = sw.cand_cols_t.launches
    kernel = sw.cand_cols_t(cfg, pos, vel, rho, mass, index)
    twin = cand_twin(cfg, pos, vel, rho, mass, index)
    diff = rows_differ(kernel, twin)
    print(f"[cand {label}] m={mass.shape[0]} indexed={index is not None} "
          f"strides pos {pos.stride()} rho {rho.stride()} mass "
          f"{mass.stride()}: elements differing {diff}")
    check(kernel.shape == twin.shape, f"{label}: columns [M, 9]")
    check(sw.cand_cols_t.launches == launches + (mass.shape[0] > 0),
          f"{label}: cand_cols_t launched")
    check(diff == 0, f"{label}: columns bit-equal to the twin")
    return diff


def cand_bytes(pos, vel, rho, mass, index=None) -> int:
    """Bytes the pass must move: ``CAND_ROW_BYTES`` a row; indexed, the
    32-byte sectors of ``pos``, ``vel`` and ``rho`` whose rows the index
    names, its own 4 B and the mass's 4 B a row, and 36 B written a row."""
    m = mass.shape[0]
    if index is None:
        return CAND_ROW_BYTES * m
    rows = index.long()

    def sectors(t: torch.Tensor, width: int) -> int:
        first = rows * (t.stride(0) * 4) + t.data_ptr() % 32
        return int(torch.unique(torch.cat(
            [first // 32, (first + 4 * width - 1) // 32])).numel())

    return 32 * (sectors(pos, 3) + sectors(vel, 3) + sectors(rho, 1)) \
        + 44 * m


def cand_timed(label: str, cfg, args: tuple, index=None) -> dict:
    """The kernel's and the twin's ms (queued CUDA events) and the bound,
    ``cand_bytes`` at the HBM rate."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw

    rec = dict(
        m=args[3].shape[0],
        ms=time_ms(lambda: sw.cand_cols_t(cfg, *args, index), iters=20,
                   warmup=3),
        plain_ms=time_ms(lambda: cand_twin(cfg, *args, index), iters=5,
                         warmup=1),
        bound_ms=cand_bytes(*args, index) / HBM_BYTES_PER_S * 1e3)
    gathers = "" if index is None else " (with its gathers)"
    print(f"[cand {label}] kernel {rec['ms']:.4f} ms, twin "
          f"{rec['plain_ms']:.4f} ms{gathers}, "
          f"bound {rec['bound_ms']:.4f} ms (bytes), "
          f"{rec['bound_ms'] / rec['ms']:.0%} of it")
    return rec


def cand_slab_inputs(dev):
    """The one-rank slab frame's force columns (``CAND_SLAB_N``
    particles) as the exact slab force passes them
    (``slab_sweeps.force_local_args``): row-strided views of the frame's
    store and a density a row."""
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import (
        slab_sweeps as ss, slabs)
    from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import (
        local_group)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        slab_setup)

    cfg, st, zsplit, caps, sub_len = slab_setup(CAND_SLAB_N, SLAB,
                                                SLAB_HEADROOM, dev)
    sub_len = slabs.frame_sub_len(cfg, "pallas", caps[0], caps[1], sub_len)
    with local_group(dev) as grp:
        carry = slabs.init_lazy_slab(
            cfg, grp, slabs.distribute(cfg, st, grp, caps[0], zsplit),
            caps[0], "pallas", sub_len)
        frame = slabs.prepare_frame(cfg, grp, *caps, "pallas", zsplit, True,
                                    sub_len, carry)
    ext = frame.ext
    g = torch.Generator(device=dev).manual_seed(22)
    rho = 0.5 + 1.5 * torch.rand(ext.shape[0], generator=g, device=dev)
    return cfg, (ext[:, 0:3], ext[:, 3:6], rho, ext[:, ss._MASS])


def cand_solve_launches(dev, name: str) -> int:
    """``cand_cols_t``'s launches, counted from 0, in ``CAND_STEPS`` lazy
    steps of ``CAND[name]``'s solve (``slab_1m``: one-rank slab steps of
    the 1M splash)."""
    from smoothed_particle_hydrodynamics_tpu_torch.ops import sweeps_t as sw
    from smoothed_particle_hydrodynamics_tpu_torch.ops.lazy import (
        drive_loop_lazy)
    from smoothed_particle_hydrodynamics_tpu_torch.parallel import slabs
    from smoothed_particle_hydrodynamics_tpu_torch.parallel.comm import (
        local_group)
    from smoothed_particle_hydrodynamics_tpu_torch.utils.benchmark import (
        resolve_scene, slab_setup)

    if name == "slab_1m":
        cfg, st, zsplit, caps, sub_len = slab_setup(
            CAND_SLAB_N, SLAB, SLAB_HEADROOM, dev)
        reset_launches()
        with local_group(dev) as grp:
            slabs.run_slab_steps(grp, cfg, st, caps, zsplit, CAND_STEPS,
                                 sweeps="pallas", sub_len=sub_len)
    else:
        scene, ov = CAND[name]
        cfg, st = resolve_scene(scene, dev, ov, backend="pallas")
        reset_launches()
        drive_loop_lazy(cfg, st, CAND_STEPS, collect_diags=False)
    torch.cuda.synchronize()
    return sw.cand_cols_t.launches


def cand_phase(dev) -> dict:
    """Phase 22: the candidate columns' kernel against its twin on each
    ``CAND`` input and on the slab frame's views, each timed beside its
    bound, then its launches in a counted solve of each configuration
    (once a step: the kernel built every step's columns)."""
    t_phase = time.perf_counter()
    out = {}
    for name in CAND:
        reset_peak(dev)
        cfg, args, index = cand_inputs(dev, name)
        rec = dict(differ=cand_vs_twin(name, cfg, *args, index))
        if index is not None:
            rec["differ_exact"] = cand_vs_twin(f"{name} unindexed", cfg,
                                               *(a[index.long()] for a in
                                                 args[:3]), args[3])
        rec.update(cand_timed(name, cfg, args, index), peak_gb=peak_gb(dev))
        out[name] = rec
        del args, index
    cfg, args = cand_slab_inputs(dev)
    out["slab_1m"] = dict(differ=cand_vs_twin("slab_1m", cfg, *args),
                          **cand_timed("slab_1m", cfg, args))
    del args
    for name in out:
        reset_peak(dev)
        n = cand_solve_launches(dev, name)
        print(f"[cand {name}] counted solve: cand_cols_t launched {n} times "
              f"in {CAND_STEPS} steps")
        check(n == CAND_STEPS, f"{name}: the kernel built every step's "
              f"columns ({n} launches in {CAND_STEPS} steps)")
        out[name]["solve_launches"] = n
    print(f"[p22] phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return out


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
    build.build_libraries(list(LIBRARIES))
    print(f"[build] {' + '.join(f'{n}.cu' for n in LIBRARIES)} built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in LIBRARIES:
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

    # 2. exact kernels vs twins, 32k splash (packed pool: 32^3 grid of
    #    1.25h cells)
    cfg, st = make_scene("splash", device=dev, num_particles=32768, **small)
    _, (args, _, _), pairs = exact_vs_twins(cfg, sw.prepare_t(cfg, st),
                                            "exact 32k")
    force_drains("exact 32k", "force_band_t", args["force_band_t"],
                 pairs["force_band_t"])

    # 3. exact kernels vs the pairwise oracle, n = 4096
    cfg, st = make_scene("splash", device=dev, **oracle_kw)
    oracle("exact 4096", cfg, st)

    # 4. the exact main path's shapes: agreement and times, the band kernels
    #    vs their twins
    cfg, st = make_scene("splash", device=dev, **MAIN)
    errs, (args, twin_args, reads), pairs = exact_vs_twins(
        cfg, sw.prepare_t(cfg, st), "exact 1M")
    times = timed(args, pairs, twin_args, reads)
    times["force_band_t"].update(force_drains(
        "exact 1M", "force_band_t", args["force_band_t"],
        pairs["force_band_t"]))
    del args, twin_args, reads

    # 5. capped kernels vs twins, 32k splash (derived sub frame, with tail)
    ov = dict(small, num_particles=32768, capped_candidates=4,
              capped_fused=True, pallas_block_t=256)
    cfg, st = make_scene("splash", device=dev, **ov)
    cfg = resolve_sweep_settings(cfg, st, ov)
    _, (args, _, _), pairs_c = capped_vs_twins(cfg, sw.prepare_t(cfg, st),
                                               "capped 32k")
    force_drains("capped 32k", "force_band_t<capped>",
                 args["force_band_t<capped>"], pairs_c["force_band_t<capped>"])

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
    capped_errs, (args, twin_args, reads), capped_pairs = \
        capped_vs_twins(cfg, p, "capped 1M")
    errs.update(capped_errs)
    pairs.update(capped_pairs)
    times.update(timed(args, capped_pairs, twin_args, reads))
    times["force_band_t<capped>"].update(force_drains(
        "capped 1M", "force_band_t<capped>", args["force_band_t<capped>"],
        capped_pairs["force_band_t<capped>"]))
    exact = cfg.replace(capped_candidates=0)
    rho_e = sw.density_sweep_t(exact, sw.prepare_t(exact, st))[0]
    rho_c = sw.density_sweep_t(cfg.replace(capped_fused=False), p)[0]
    ratio = rho_c.double().mean().item() / rho_e.double().mean().item()
    print(f"[capped 1M] capped rho mean / exact rho mean on the same state: "
          f"{ratio:.6f}")
    check(0.99 < ratio < 1.01, f"capped density unbiased: ratio {ratio}")
    del p, args, twin_args, reads, st, rho_e, rho_c

    # 8. lane band kernels vs twins: a 32k packed splash with 128-row
    #    windows (multi-chunk), a frame whose windows the 127-chunk clamp
    #    cuts, then the lane main path's 1M shapes, timed
    cfg, st = make_scene("splash", device=dev, num_particles=32768,
                         grid_nx=32, grid_ny=32, grid_nz=32,
                         pallas_layout="lane", pallas_window=128)
    lane_vs_twins(cfg, st, "lane 32k")
    cfg, st = clamped_lane_state(dev)
    cut = lane_vs_twins(cfg, st, "lane clamped", twins=False)
    check(cut > 0, f"lane clamped: the 127 clamp cut chunks ({cut})")
    cfg, st = make_scene("splash", device=dev, **LANE)
    lane_errs, (args, twin_args, reads), lane_pairs = lane_vs_twins(
        cfg, st, "lane 1M")
    errs.update(lane_errs)
    pairs.update(lane_pairs)
    times.update(timed(args, lane_pairs, twin_args, reads))
    del args, twin_args, reads, st
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

    # 10. the main paths, counted (the counter kernel too: no path runs it
    #     unprofiled)
    launches, counter_launches, cand_launches = {}, 0, {}
    for path, (ov, names) in PATHS.items():
        lazy = path != "lane"
        reset_launches()
        r = run_benchmark(scene="splash", lazy=lazy, steps=STEPS,
                          warmup=WARMUP, overrides=ov, device="cuda",
                          backend="pallas")
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
        kdk = _modules()["integrate"].integrate_t.launches
        check(kdk == total_steps, f"{path}: integrate_t launched {kdk} "
              f"times in {total_steps} steps")
        launches.setdefault("integrate_t", kdk)
        # K2's candidate columns: one launch a step on the sublane paths
        cols = sw.cand_cols_t.launches
        want = 0 if path == "lane" else total_steps
        check(cols == want, f"{path}: cand_cols_t launched {cols} times in "
              f"{total_steps} steps, want {want}")
        cand_launches[path] = cols
        rows = sw.band_rows_t.launches
        check(rows == 0, f"{path}: band_rows_t launched {rows} times with "
              "no profiler running")
        counter_launches += rows
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
    counts["integrate_t"] = _modules()["integrate"].integrate_t.launches
    counts["cand_cols_t"] = sw.cand_cols_t.launches
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
    #     (world size 1: both halos are inert chain ends here), with rows
    #     per lane equal to the single-chip band walks' on the same state
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
                slab_errs, args, slab_pairs, reads, stats = \
                    slab_capped_vs_twins(cfg, grp, frame, caps, label)
                times.update(timed(args, slab_pairs, reads=reads))
                # the sub frame keeps each cell's single-chip count
                p1 = sw.prepare_t(cfg, st)
                same_table = bool(torch.equal(frame.tabs[-1].cell_start,
                                              p1.cell_start))
                del args, reads
                fused_errs, args, fused_pairs, reads = \
                    slab_fused_vs_twins(cfg, grp, frame, caps, label)
                slab_errs.update(fused_errs)
                slab_pairs.update(fused_pairs)
                times.update(timed(args, fused_pairs, reads=reads))
                del reads
            else:
                slab_errs, args, slab_pairs, bands, stats = \
                    slab_exact_vs_twins(cfg, grp, frame, caps, label)
                times.update(timed(args, slab_pairs, reads=bands[1],
                                   launch=bands[0]))
                p1 = sw.prepare_t(cfg, st)
                same_table = True
                del bands
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
    # than h_cap; every rank held to its twins
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

    # 14. the slab main paths, counted; then single-chip and slab in turns
    for path, (ov, names) in SLAB_PATHS.items():
        reset_launches()
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
        cols = sw.cand_cols_t.launches
        check(cols == total_steps, f"{path}: cand_cols_t launched {cols} "
              f"times in {total_steps} steps")
        cand_launches[path] = cols
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
    floor_errs, floor_recs = floor_vs_plain(dev)
    errs.update(floor_errs)
    times.update(floor_recs)
    gather_in_turns(dev)
    queued_timer(dev)
    chain_ranges(dev)
    reset_launches()
    vpu, gat, mxu = probe_vpu_ops.main(), probe_gather.main(), probe_mxu.main()
    hw_probes = [n for n in PROBE_KERNELS if n not in FLOOR_KERNELS]
    for name in hw_probes:
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
              + f"), {t['bound_ms'] / t['ms']:.0%} of it"
              + (f"; {launches[name]} launches in the probe run"
                 if name in launches else ""))
    print(f"[probe] phase 15 took {time.perf_counter() - t0:.1f} s")

    # 16. the CLI on the card: the reference's headless run with its
    #     outputs and checkpoints, resumes, an apply, the 1M splash's
    #     outputs, info, watch and a sweep
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_",
                                dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        ckpt = os.path.join(ckpt_dir, "ckpt.npz")
        cli_phase(dev, keep=ckpt)

        # 17. the renderer, lane groups, compat mode and the examples
        slice_phase(dev, ckpt)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # 18. the multi-rank work: run --devices 2, slab and halo, the three-way
    #     step, the dry runs, the distributed example, the staging share
    devices_phase(dev)

    # 19. the study and profiling tools, the five probes and the
    #     strong-scaling projection
    launches.update(tools_phase(dev)["floor_launches"])

    # 20. the single-card 10M configurations: kernels against twins, then
    #     the bench loops
    tenm_phase(dev)

    # 21. the integrator's kernel against its twin at 1M and 10M, timed
    integ = integrate_phase(dev)

    # 22. K2's candidate columns against their twin in the three cells and
    #     on a slab frame, timed; the share of a profiled solve's columns
    cand = cand_phase(dev)

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
         **{key: times[name][key] for key in ("case", *DRAIN_KEYS)
            if key in times[name]}}
        for name, k in KERNELS.items()],
        # the counter kernel: its launches in the main paths (phase 10)
        "counters": [{"name": "band_rows_t", "route": "cuda",
                      "source": SOURCE_T, "launches": counter_launches}],
        # the integrator's kernel (no TPU kernel): its launches in the 1M
        # exact path (phase 10), its times at each size (phase 21)
        "integrate": [{"name": "integrate_t", "route": "cuda",
                       "source": SOURCE_INTEGRATE, "replaces": None,
                       "launches": launches["integrate_t"], "case": name,
                       "n": r["n"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": "bytes"}
                      for name, r in integ.items()],
        # K2's candidate columns (no TPU kernel): its launches in the main
        # path of each input's mode (phases 10 and 14), its times at each
        # input (phase 22)
        "cand_cols": [{"name": "cand_cols_t", "route": "cuda",
                       "source": SOURCE_CAND, "replaces": None,
                       "launches": cand_launches[CAND_PATH[name]],
                       "case": name, "m": r["m"], "ms": r["ms"],
                       "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": "bytes",
                       "solve_launches": r["solve_launches"]}
                      for name, r in cand.items()]}))
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
