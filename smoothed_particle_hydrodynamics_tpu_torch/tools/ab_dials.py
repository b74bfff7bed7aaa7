"""A/B the lazy driver under config-dial overrides, in turns inside one
process: counterpart of ``tools/ab_dials.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.ab_dials \\
        [N] [K_c] [rounds] [block] [only,names] [--device cpu]

Every variant gets its own config, settled carry (10 lazy steps) and step
(``ops.lazy.lazy_step``); then the measurement goes round the variants in
``rounds`` rounds of ``block`` steps each (V1 block, V2 block, ..., V1
block, ...), each step timed on the host clock (ended by a device sync),
so drift across the run falls on every variant alike.  Each variant prints
its mean, its median steady and rebin step and its rebins, and ``fp``, the
sum of the x velocities of its final state: a fingerprint of the steps it
took, the same when it runs alone (``tests/test_torch_tools_ab.py``).
The variants are the JAX tool's: the block width and the cell size.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..models import make_scene
from ..ops import lazy
from . import derive_settings, host_tag, start, steady_rebin, sync

VARIANTS = [
    ("baseline", {}),
    # wider kernel blocks: fewer per-(block, rod) costs for more window rows
    ("block256", {"pallas_block_t": 256}),
    ("block512", {"pallas_block_t": 512}),
    # cell size as a capped-mode dial: bigger cells bind K_c harder (fewer
    # swept rows) and widen the drift skin (fewer rebins), at the cost of
    # sampling noise (tools/capped_noise.py measures it)
    ("csf1.5", {"cell_size_factor": 1.5}),
    ("csf1.75", {"cell_size_factor": 1.75}),
    ("csf2.0", {"cell_size_factor": 2.0}),
    ("csf2.5", {"cell_size_factor": 2.5}),
]

SETTLE = 10


def fingerprint(carry) -> float:
    """The sum of the x velocities of a lazy carry's state."""
    return float(carry.state.velocity[:, 0].sum())


class Variant:
    def __init__(self, name, extra, n, k_c, dev, settle=SETTLE):
        self.name, self.dev = name, dev
        ov = dict(num_particles=n, cell_size_factor=1.25)
        if k_c:
            ov.update(capped_candidates=k_c, pallas_window_t=0)
        ov.update(extra)
        cfg, state = make_scene("splash", device=dev, **ov)
        self.cfg = cfg = derive_settings(cfg, state)
        self.carry, _ = lazy.drive_loop_lazy(cfg, state, settle,
                                             collect_diags=False,
                                             keep_carry=True)
        sync(dev)
        self.times, self.rebinned = [], []

    def measure_block(self, block):
        rb_prev = self.carry.rebin_count
        for _ in range(block):
            sync(self.dev)
            t0 = time.perf_counter()
            self.carry, _ = lazy.lazy_step(self.cfg, self.carry)
            sync(self.dev)
            self.times.append((time.perf_counter() - t0) * 1000)
            self.rebinned.append(self.carry.rebin_count > rb_prev)
            rb_prev = self.carry.rebin_count

    def report(self) -> dict:
        t = np.asarray(self.times)
        steady, rebin = steady_rebin(t, self.rebinned, np.median)
        rebins = sum(self.rebinned)
        fp = fingerprint(self.carry)
        print(f"{self.name:14s} mean {t.mean():8.3f}  steady-med {steady:8.3f}"
              f" ms  rebin-med {rebin:8.3f} ms{host_tag(self.dev)}  (rebins "
              f"{rebins}/{len(t)})  fp {fp:+.6e}", flush=True)
        return dict(mean_ms=float(t.mean()), steady_med_ms=steady,
                    rebin_med_ms=rebin, rebins=rebins, steps=len(t), fp=fp)


def main(n=1_000_000, k_c=0, rounds=4, block=10, only=None, device="cuda",
         settle=SETTLE) -> dict:
    dev = start(device)
    names = [(nm, ex) for nm, ex in VARIANTS if not only or nm in only]
    print(f"n={n} K_c={k_c} rounds={rounds} block={block} device={dev}",
          flush=True)
    variants = []
    for nm, ex in names:
        print(f"  building {nm} ...", flush=True)
        variants.append(Variant(nm, ex, n, k_c, dev, settle))
    for r in range(rounds):
        for v in variants:
            v.measure_block(block)
        print(f"  round {r + 1}/{rounds} done", flush=True)
    return {v.name: v.report() for v in variants}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "ab_dials")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=0)
    ap.add_argument("rounds", nargs="?", type=int, default=4)
    ap.add_argument("block", nargs="?", type=int, default=10)
    ap.add_argument("only", nargs="?", default=None,
                    help="comma-separated variant names")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.rounds, a.block,
         a.only.split(",") if a.only else None, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
