"""A/B the slab engine under config-dial overrides, in turns inside one
process: counterpart of ``tools/ab_slab.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.ab_slab \\
        [N] [K_c] [rounds] [block_calls] [grid_nz] [scan_block] [only,names] \\
        [--device cpu]

``ab_dials``'s design on the slab engine at ``run_slab_benchmark``'s
geometry (``utils/benchmark.py``): the splash at 1.25h cells, block 256,
default 125k particles capped K_c 4 in a 16-plane box (the strong-scaling
proxy: one rank's load of an eight-rank run), on a one-rank group of this
device (NCCL on the card, gloo on the CPU), ``scan_block`` steps a call.
Every variant gets its own config, store and step and two calls to
settle; then the measurement goes round the variants in ``rounds`` rounds
of ``block_calls`` calls each, every call timed on the host clock (ended
by a device sync) per step.  A variant that cannot be built is reported
and left out.  Each prints its mean, median and 10th percentile ms/step,
its rebins, the migration loss of its last step, and ``fp``, the sum of
the x velocities over its valid rows (the same when it runs alone).

The variants are the JAX tool's.  The ``_scan_block`` variants set the
steps a call; the port's slab step loops the same step that many times
(``parallel/slabs.py``), so they measure only what fewer calls save on the
host, not a fused scan as on the TPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models import make_scene
from ..parallel import comm
from . import derive_settings, host_tag, start, sync
from .ab_engines import slab_engine

VARIANTS = [
    ("baseline", {}),
    ("block512", {"pallas_block_t": 512}),
    ("block128", {"pallas_block_t": 128}),
    ("csf1.0", {"cell_size_factor": 1.0}),
    ("csf1.5", {"cell_size_factor": 1.5}),
    ("csf1.75", {"cell_size_factor": 1.75}),
    ("csf2.0", {"cell_size_factor": 2.0}),
    ("csf2.5", {"cell_size_factor": 2.5}),
    ("csf1.75+b512", {"cell_size_factor": 1.75, "pallas_block_t": 512}),
    ("csf2.0+b512", {"cell_size_factor": 2.0, "pallas_block_t": 512}),
    ("csf3.0", {"cell_size_factor": 3.0}),
    ("csf2.5+sb16", {"cell_size_factor": 2.5, "_scan_block": 16}),
    ("csf3.0+sb16", {"cell_size_factor": 3.0, "_scan_block": 16}),
    ("csf2.5+sb32", {"cell_size_factor": 2.5, "_scan_block": 32}),
    ("csf3.0+sb32", {"cell_size_factor": 3.0, "_scan_block": 32}),
    ("csf1.25+sb16", {"_scan_block": 16}),
    ("csf2.5+sb64", {"cell_size_factor": 2.5, "_scan_block": 64}),
    ("csf3.0+sb64", {"cell_size_factor": 3.0, "_scan_block": 64}),
    ("csf4.0+sb32", {"cell_size_factor": 4.0, "_scan_block": 32}),
    ("csf4.0+sb64", {"cell_size_factor": 4.0, "_scan_block": 64}),
    ("csf3.0+sb32+w64", {"cell_size_factor": 3.0, "_scan_block": 32,
                         "pallas_window_t": 64}),
    ("csf3.0+sb32+b512", {"cell_size_factor": 3.0, "_scan_block": 32,
                          "pallas_block_t": 512}),
    ("csf3.0+sb64+b512", {"cell_size_factor": 3.0, "_scan_block": 64,
                          "pallas_block_t": 512}),
    ("csf4.0+sb64+b512", {"cell_size_factor": 4.0, "_scan_block": 64,
                          "pallas_block_t": 512}),
    ("csf4.0+sb64+b512+w40", {"cell_size_factor": 4.0, "_scan_block": 64,
                              "pallas_block_t": 512, "pallas_window_t": 40}),
    ("csf5.0+sb64+b512", {"cell_size_factor": 5.0, "_scan_block": 64,
                          "pallas_block_t": 512}),
    ("csf6.0+sb64+b512", {"cell_size_factor": 6.0, "_scan_block": 64,
                          "pallas_block_t": 512}),
    ("csf5.0+sb128+b512", {"cell_size_factor": 5.0, "_scan_block": 128,
                           "pallas_block_t": 512}),
    ("csf4.0+sb128+b512", {"cell_size_factor": 4.0, "_scan_block": 128,
                           "pallas_block_t": 512}),
    ("csf4.0+sb64+b512+fused", {"cell_size_factor": 4.0, "_scan_block": 64,
                                "pallas_block_t": 512, "capped_fused": True}),
    ("csf5.0+sb64+b512+fused", {"cell_size_factor": 5.0, "_scan_block": 64,
                                "pallas_block_t": 512, "capped_fused": True}),
    ("csf2.5+sb32+fused", {"cell_size_factor": 2.5, "_scan_block": 32,
                           "capped_fused": True}),
    ("csf1.25+sb8+fused", {"_scan_block": 8, "capped_fused": True}),
    ("csf6.0+sb64+b512+fused", {"cell_size_factor": 6.0, "_scan_block": 64,
                                "pallas_block_t": 512, "capped_fused": True}),
    ("csf6.0+sb128+b512+fused", {"cell_size_factor": 6.0, "_scan_block": 128,
                                 "pallas_block_t": 512, "capped_fused": True}),
    ("csf5.0+sb128+b512+fused", {"cell_size_factor": 5.0, "_scan_block": 128,
                                 "pallas_block_t": 512, "capped_fused": True}),
    ("csf8.0+sb128+b512+fused", {"cell_size_factor": 8.0, "_scan_block": 128,
                                 "pallas_block_t": 512, "capped_fused": True}),
]

SETTLE_CALLS = 2
SCAN_BLOCK_NOTE = ("the _scan_block variants loop the same slab step K "
                   "times a call (no fused scan in the port)")


def slab_fingerprint(carry) -> float:
    """The sum of the x velocities over a slab store's valid rows."""
    f = carry.fields
    return float(f[:, 3][f[:, 7] >= 0.0].sum())


class Variant:
    def __init__(self, name, extra, n, k_c, grid_nz, scan_block, group, dev,
                 settle_calls=SETTLE_CALLS):
        self.name, self.dev = name, dev
        extra = dict(extra)
        scan_block = extra.pop("_scan_block", scan_block)
        ov = dict(num_particles=n, cell_size_factor=1.25, pallas_block_t=256)
        if grid_nz:
            ov["grid_nz"] = grid_nz
        if k_c:
            ov.update(capped_candidates=k_c, pallas_window_t=0)
        ov.update(extra)
        cfg, state = make_scene("splash", device=dev, **ov)
        cfg = derive_settings(cfg, state)
        cfg.validate()
        self.carry, self.step, _, _ = slab_engine(cfg, state, group,
                                                  scan_block=scan_block)
        self.k = max(scan_block, 1)
        for _ in range(settle_calls):          # settle off the clock
            self.carry, self.diag = self.step(self.carry)
        sync(dev)
        self.times = []

    def measure_block(self, calls):
        for _ in range(calls):
            sync(self.dev)
            t0 = time.perf_counter()
            self.carry, self.diag = self.step(self.carry)
            sync(self.dev)
            self.times.append((time.perf_counter() - t0) * 1000 / self.k)

    def report(self) -> dict:
        t = np.asarray(self.times)
        fp = slab_fingerprint(self.carry)
        mig = int(self.diag.migration_dropped.reshape(-1)[-1])
        print(f"{self.name:16s} mean {t.mean():8.3f}  med {np.median(t):8.3f}"
              f"  p10 {np.percentile(t, 10):8.3f} ms/step{host_tag(self.dev)}"
              f"  rebins {self.carry.rebin_count}  mig_drop {mig}"
              f"  fp {fp:+.6e}", flush=True)
        return dict(mean_ms=float(t.mean()), med_ms=float(np.median(t)),
                    p10_ms=float(np.percentile(t, 10)),
                    rebins=self.carry.rebin_count, mig_drop=mig, fp=fp)


def main(n=125_000, k_c=4, rounds=4, block_calls=5, grid_nz=16, scan_block=8,
         only=None, device="cuda", settle_calls=SETTLE_CALLS) -> dict:
    dev = start(device)
    names = [(nm, ex) for nm, ex in VARIANTS if not only or nm in only]
    print(f"n={n} K_c={k_c} rounds={rounds} calls/round={block_calls} "
          f"grid_nz={grid_nz} scan_block={scan_block} device={dev}",
          flush=True)
    if any("_scan_block" in ex for _, ex in names):
        print(f"  note: {SCAN_BLOCK_NOTE}", flush=True)
    variants = []
    with comm.local_group(dev) as group:
        for nm, ex in names:
            print(f"  building {nm} ...", flush=True)
            try:
                variants.append(Variant(nm, ex, n, k_c, grid_nz, scan_block,
                                        group, dev, settle_calls))
            except Exception as e:  # noqa: BLE001 - a variant that cannot
                print(f"  {nm} FAILED to build: {e!r:.300}", flush=True)
        for r in range(rounds):
            for v in variants:
                v.measure_block(block_calls)
            print(f"  round {r + 1}/{rounds} done", flush=True)
    return {v.name: v.report() for v in variants}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "ab_slab")
    ap.add_argument("n", nargs="?", type=int, default=125_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("rounds", nargs="?", type=int, default=4)
    ap.add_argument("block_calls", nargs="?", type=int, default=5)
    ap.add_argument("grid_nz", nargs="?", type=int, default=16)
    ap.add_argument("scan_block", nargs="?", type=int, default=8)
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated variant names")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.rounds, a.block_calls, a.grid_nz, a.scan_block,
         a.only.split(",") if a.only else None, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
