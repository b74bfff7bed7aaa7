"""Per-step drift/skin and rebin trace of the single-device lazy driver:
counterpart of ``tools/trace_drift.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.trace_drift \\
        [N] [K_c] [csf] [steps] [--device cpu]

Settles the splash (default 1M, capped K_c 4 at 1.25h cells; K_c 0 is
exact) for 10 lazy steps, then times each of ``steps`` more steps
(``ops.lazy.lazy_step``; host clock ended by a device sync), marks the
steps that rebinned (``LazyCarry.rebin_count`` rose) and prints the largest
per-particle displacement since binning (``LazyCarry.pos_bin``) over the
skin, ``skin_half`` = (cell - h) / 2: how fast drift eats the skin between
rebins, beside ``profile_slab``'s drift column.  Last, the mean steady and
rebin step times and the rebin count.
"""

from __future__ import annotations

import argparse
import time

from ..models import make_scene
from ..ops import lazy
from . import derive_settings, host_tag, start, steady_rebin, sync


def main(n=1_000_000, k_c=4, csf=1.25, steps=24, settle=10, device="cuda"
         ) -> dict:
    dev = start(device)
    ov = dict(num_particles=n, cell_size_factor=csf)
    if k_c:
        ov.update(capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **ov)
    cfg = derive_settings(cfg, state)
    skin = lazy.skin_half(cfg)
    print(f"n={n} K_c={k_c} csf={csf} skin={skin:.6f} device={dev}")

    carry, _ = lazy.drive_loop_lazy(cfg, state, settle,
                                    collect_diags=False, keep_carry=True)
    host = host_tag(dev)
    rb_prev = carry.rebin_count
    times, rebinned, drifts = [], [], []
    for i in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        carry, _ = lazy.lazy_step(cfg, carry)
        sync(dev)
        dt = (time.perf_counter() - t0) * 1000
        fired = carry.rebin_count > rb_prev
        rb_prev = carry.rebin_count
        drift = float((carry.state.position - carry.pos_bin).abs().max())
        times.append(dt)
        rebinned.append(fired)
        drifts.append(drift / skin)
        print(f"  step {settle + i:3d}  {dt:9.3f} ms{host}  "
              f"{'REBIN' if fired else '     '}  drift/skin {drift/skin:5.2f}")
    steady, rebin = steady_rebin(times, rebinned)
    if not all(rebinned):
        print(f"steady {steady:8.3f} ms  rebin {rebin:8.3f} ms{host}  "
              f"rebins {sum(rebinned)}/{steps}")
    return dict(skin=skin, times_ms=times, rebinned=rebinned,
                drift_over_skin=drifts, steady_ms=steady, rebin_ms=rebin)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "trace_drift")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("csf", nargs="?", type=float, default=1.25)
    ap.add_argument("steps", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.csf, a.steps, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
