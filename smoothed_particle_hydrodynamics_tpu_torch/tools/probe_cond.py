"""What the lazy step's rebin test costs on frozen steps: counterpart of
``tools/probe_cond.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_cond \\
        [N] [K_c] [rounds] [--device cpu]

The JAX tool asks whether ``lax.cond`` copies the whole carry every frozen
step.  The port decides on the host: ``ops.lazy.lazy_step`` reads its drift
test back every step (``bool(spread > ...)``), which waits for the card to
finish the step's drift reduction before the next launch.  This probe
interleaves, in ABAB rounds from one settled carry (the splash, default 1M
capped K_c 4 at 1.25h cells, window and sub frame derived, 10 lazy steps):

  A. the production ``lazy_step``, pinned to frozen steps (``pin_frozen``:
     ``pos_bin`` reset each call, so the test never fires; the read stays),
  B. ``frozen_step``: the same sweeps, ``kdk_integrate`` and diagnostics,
     with no drift test and no host read,
  C. B with the sweeps stubbed (``frozen_step_nosweeps``): the step's
     machinery without its kernels,

each for 10 steps a round (host clock, ended by a device sync), and prints
every round and the medians.  A - B is what the host read costs a step; A
and B give the same state and diagnostics bit for bit
(``tests/test_torch_tools_probes.py``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..models import make_scene
from ..ops import lazy
from ..ops import sweeps_t as pst
from ..ops.integrate import kdk_integrate
from ..state import make_step_diagnostics
from . import derive_settings, host_tag, start, sync

BLOCK = 10      # steps a round
SETTLE = 10     # lazy steps before the rounds


def frozen_step(cfg, carry: lazy.LazyCarry):
    """``lazy_step`` without its drift test: always the frozen path."""
    st = carry.state
    p = pst.PreparedT(order=carry.order, pos_s=st.position,
                      vel_s=st.velocity, mass_s=st.mass, cid=carry.cid,
                      cell_start=carry.cell_start,
                      **{k: getattr(carry, k) for k in pst.SUB_FIELDS})
    acc_s, rho_s, ncount_s = pst.sweeps_sorted(cfg, p)
    st = st._replace(density=rho_s, neighbor_count=ncount_s)
    new_state, tally = kdk_integrate(cfg, st, acc_s)
    zero = torch.zeros((), dtype=torch.int32, device=ncount_s.device)
    return (carry._replace(state=new_state,
                           steps_since=carry.steps_since + 1),
            make_step_diagnostics(tally, ncount_s, zero,
                                  pst.truncated_ranges(p)))


def frozen_step_nosweeps(cfg, carry: lazy.LazyCarry):
    """``frozen_step`` with the sweeps replaced by constants that still
    read the positions (so nothing before them is skipped)."""
    st = carry.state
    n = st.position.shape[0]
    live = st.position[:, 0].sum() * 1e-30
    acc_s = torch.zeros((n, 3), dtype=torch.float32,
                        device=st.position.device) + live
    rho_s = torch.ones_like(st.mass)
    ncount_s = torch.zeros(n, dtype=torch.int32, device=st.position.device)
    st = st._replace(density=rho_s, neighbor_count=ncount_s)
    new_state, tally = kdk_integrate(cfg, st, acc_s)
    zero = torch.zeros((), dtype=torch.int32, device=ncount_s.device)
    return (carry._replace(state=new_state,
                           steps_since=carry.steps_since + 1),
            make_step_diagnostics(tally, ncount_s, zero, zero))


def pin_frozen(carry: lazy.LazyCarry) -> lazy.LazyCarry:
    """``pos_bin`` reset to the current positions: the drift test never
    fires."""
    return carry._replace(pos_bin=carry.state.position)


def settled(n: int, k_c: int, dev: torch.device):
    """(cfg, carry): the JAX tool's splash, settled for ``SETTLE`` lazy
    steps."""
    ov = dict(num_particles=n, cell_size_factor=1.25)
    if k_c:
        ov.update(capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **ov)
    cfg = derive_settings(cfg.replace(pallas_window_t=0), state)
    carry, _ = lazy.drive_loop_lazy(cfg, state, SETTLE, collect_diags=False,
                                    keep_carry=True)
    return cfg, carry


def main(n=1_000_000, k_c=4, rounds=4, device="cuda") -> dict:
    dev = start(device)
    cfg, carry = settled(n, k_c, dev)
    print(f"n={n} K_c={k_c} window_t={cfg.pallas_window_t} device={dev}",
          flush=True)
    variants = {
        "A lazy_step (host read)": lambda c: lazy.lazy_step(cfg, c),
        "B frozen, no read": lambda c: frozen_step(cfg, c),
        "C frozen, no sweeps": lambda c: frozen_step_nosweeps(cfg, c),
    }
    for f in variants.values():      # first calls off the clock
        f(pin_frozen(carry))
    sync(dev)
    host = host_tag(dev)
    ms = {name: [] for name in variants}
    for r in range(rounds):
        for name, f in variants.items():
            c = pin_frozen(carry)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(BLOCK):
                c, _ = f(pin_frozen(c))
            sync(dev)
            dt = (time.perf_counter() - t0) / BLOCK * 1e3
            ms[name].append(dt)
            print(f"round {r} {name:24s} {dt:8.3f} ms{host}", flush=True)
    print()
    med = {name: float(np.median(ts)) for name, ts in ms.items()}
    for name, t in med.items():
        print(f"{name:24s} median {t:8.3f} ms{host}")
    a, b, c = med.values()
    print(f"A - B (the host read at ops/lazy.py's drift test) {a - b:8.3f} "
          f"ms{host}; B - C (the sweeps) {b - c:8.3f} ms{host}")
    return dict(ms=ms, median=med, read_ms=a - b, sweeps_ms=b - c)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "probe_cond")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("rounds", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.rounds, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
