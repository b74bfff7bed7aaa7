"""Ablation profile of the single-device lazy step, capped or exact:
counterpart of ``tools/profile_lazy.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.profile_lazy \\
        [N] [K_c] [csf] [steps] [--device cpu]

Settles the splash (default 1M, capped K_c 4 at 1.25h cells; K_c 0 is
exact) for 10 lazy steps, then times the lazy step one step at a time
(host clock, ended by a device sync), steady steps apart from rebin steps:
first the full step, then, each from the same settled carry, the step with
one stage replaced by a stub (the diagnostics' reductions, the
integration and its energy tally, the sweeps), and with all three; "full
minus variant" is that stage's share of the step.  The steps are built
here (``step_fn``) from the parts ``ops.lazy.lazy_step`` calls, so the
driver has no switch for the ablation; with no stub ``step_fn`` is
``lazy_step`` bit for bit (``tests/test_torch_tools_profile.py``).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import _f32
from ..models import make_scene
from ..ops import lazy
from ..ops import sweeps_t as pst
from ..ops.integrate import EnergyTally, kdk_integrate
from ..state import StepDiagnostics, make_step_diagnostics
from . import derive_settings, host_tag, start, steady_rebin, sync


def step_fn(cfg, diagnostics=make_step_diagnostics, integrate=kdk_integrate,
            sweeps=pst.sweeps_sorted):
    """``lazy.lazy_step`` of ``cfg`` with its three stages given."""
    def step(carry: lazy.LazyCarry):
        spread = lazy.drift_spread(carry.state.position, carry.pos_bin)
        if bool(spread > _f32(2.0 * lazy.skin_half(cfg))):
            carry = lazy._bin(cfg, carry.state, carry.order, 0,
                              carry.rebin_count + 1)
        else:
            carry = carry._replace(steps_since=carry.steps_since + 1)
        st = carry.state
        p = pst.PreparedT(order=carry.order, pos_s=st.position,
                          vel_s=st.velocity, mass_s=st.mass, cid=carry.cid,
                          cell_start=carry.cell_start,
                          **{k: getattr(carry, k) for k in pst.SUB_FIELDS})
        acc_s, rho_s, ncount_s = sweeps(cfg, p)
        st = st._replace(density=rho_s, neighbor_count=ncount_s)
        new_state, tally = integrate(cfg, st, acc_s)
        zero = torch.zeros((), dtype=torch.int32, device=ncount_s.device)
        return carry._replace(state=new_state), diagnostics(
            tally, ncount_s, zero, pst.truncated_ranges(p))
    return step


def stub_diagnostics(tally, ncount, overflow_cells, truncated_ranges=None,
                     **kw) -> StepDiagnostics:
    zf = torch.zeros((), dtype=torch.float32, device=ncount.device)
    zi = torch.zeros((), dtype=torch.int32, device=ncount.device)
    return StepDiagnostics(zf, zf, zf, zf, zi, zi, zi, zi, zi, zi)


def stub_integrate(cfg, st, acc):
    """Frozen motion (no drift, so no rebins: the steady floor) and a zero
    tally."""
    z = torch.zeros((), dtype=torch.float32, device=acc.device)
    return st._replace(acceleration=acc), EnergyTally(
        z, z, z, torch.zeros(3, dtype=torch.float32, device=acc.device))


def stub_sweeps(cfg, p):
    nrows = p.pos_s.shape[0]
    dev = p.pos_s.device
    return (torch.zeros(nrows, 3, dtype=torch.float32, device=dev),
            torch.ones(nrows, dtype=torch.float32, device=dev),
            torch.zeros(nrows, dtype=torch.int32, device=dev))


VARIANTS = [
    ("no diag reduces", {"diagnostics": stub_diagnostics}),
    ("no kdk+tally (frozen)", {"integrate": stub_integrate}),
    ("no sweeps", {"sweeps": stub_sweeps}),
    ("machinery only", {"diagnostics": stub_diagnostics,
                        "integrate": stub_integrate,
                        "sweeps": stub_sweeps}),
]


def _trace(step, carry, steps, label, dev) -> tuple:
    times, rebinned = [], []
    rb_prev = carry.rebin_count
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        carry, _ = step(carry)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1000)
        rebinned.append(carry.rebin_count > rb_prev)
        rb_prev = carry.rebin_count
    steady, rebin = steady_rebin(times, rebinned)
    print(f"{label:30s} steady {steady:8.3f} ms  rebin {rebin:8.3f} ms"
          f"{host_tag(dev)}  (rebins {sum(rebinned)}/{steps})", flush=True)
    return carry, steady, rebin


def main(n=1_000_000, k_c=4, csf=1.25, steps=20, settle=10, device="cuda"
         ) -> dict:
    dev = start(device)
    ov = dict(num_particles=n, cell_size_factor=csf)
    if k_c:
        ov.update(capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **ov)
    cfg = derive_settings(cfg, state)
    print(f"n={n} K_c={k_c} csf={csf} window_t={cfg.pallas_window_t} "
          f"sub_len={cfg.capped_sub_len} device={dev}")

    carry, _ = lazy.drive_loop_lazy(cfg, state, settle,
                                    collect_diags=False, keep_carry=True)
    out = {}
    carry, *out["full step"] = _trace(step_fn(cfg), carry, steps,
                                      "full step", dev)
    for label, stubs in VARIANTS:
        # each from the same carry (no stage writes into its inputs), one
        # step off the clock first, as the JAX tool
        fn = step_fn(cfg, **stubs)
        cv, _ = fn(carry)
        _, *out[label] = _trace(fn, cv, max(steps // 2, 8), label, dev)
    return dict(steady_rebin_ms=out)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "profile_lazy")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("csf", nargs="?", type=float, default=1.25)
    ap.add_argument("steps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.csf, a.steps, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
