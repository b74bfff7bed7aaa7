"""Phase-by-phase times of the sublane kernels' step, exact and capped:
counterpart of ``tools/profile_pallas.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.profile_pallas \\
        [N] [K_c] [csf] [--device cpu]

Settles the splash (default 1M, capped K_c 4 at 1.25h cells; K_c 0 is exact
with window 208) for 10 lazy steps, then times each phase of the lazy step
on the settled sorted state: the rebuild (``ops.sweeps_t.prepare_t``), the
density and force sweeps (``density_sweep_t``, ``force_sweep_t``, each with
the capped sub-frame gathers they make), the capped mode's sub-frame
gathers alone (one launch each: queued CUDA events), the integration
(``ops.integrate.kdk_integrate``) and the lazy step end to end over 20
steps from a fresh carry (``ops.lazy.lazy_step``), with its rebins.  The
composite phases run 10 times on the host clock, ended by a device sync.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..models import make_scene
from ..ops import lazy, sweeps_t as pst
from ..ops.integrate import kdk_integrate
from . import Phases, derive_settings, start, sync


def main(n=1_000_000, k_c=4, csf=1.25, steps_settle=10, device="cuda",
         iters: int = 10, lazy_iters: int = 20) -> dict:
    dev = start(device)
    overrides = dict(num_particles=n, cell_size_factor=csf)
    if k_c:
        overrides.update(capped_candidates=k_c, pallas_window_t=0)
    else:
        overrides["pallas_window_t"] = 208
    cfg, state = make_scene("splash", device=dev, **overrides)
    cfg = derive_settings(cfg, state)
    print(f"n={n} K_c={k_c} window_t={cfg.pallas_window_t} "
          f"sub_len={cfg.capped_sub_len} device={dev}")

    # settle into mid-splash so occupancies are realistic
    carry, _ = lazy.drive_loop_lazy(cfg, state, steps_settle,
                                    collect_diags=False, keep_carry=True)
    state_s = carry.state
    ph = Phases(dev)

    p = ph.host("prepare_t (rebuild)", pst.prepare_t, cfg, state_s,
                iters=iters)
    rho_s, _ = ph.host("density sweep (incl. gathers)", pst.density_sweep_t,
                       cfg, p, iters=iters)
    ph.host("force sweep (incl. gathers)", pst.force_sweep_t, cfg, p, rho_s,
            iters=iters)
    if k_c:
        ph.events("  sub gather density [S,3]",
                  lambda p: p.pos_s[p.sub_perm], p)
        ph.events("  sub gather force   [S,7]",
                  lambda p, r: torch.cat([p.pos_s, p.vel_s, r[:, None]],
                                         dim=1)[p.sub_perm], p, rho_s)

    acc_s = torch.zeros_like(state_s.position)
    ph.host("kdk_integrate", kdk_integrate, cfg, state_s, acc_s, iters=iters)

    # the lazy step from a fresh carry of the settled state
    c = lazy.init_lazy(cfg, state_s)
    c, _ = lazy.lazy_step(cfg, c)
    sync(dev)
    rb0 = c.rebin_count
    t0 = time.perf_counter()
    for _ in range(lazy_iters):
        c, _ = lazy.lazy_step(cfg, c)
    sync(dev)
    dt = (time.perf_counter() - t0) / lazy_iters * 1000
    rebins = c.rebin_count - rb0
    ph.show("lazy step end-to-end", dt,
            f"   (rebins {rebins}/{lazy_iters})")
    return dict(ms=ph.ms, rebins=rebins, window_t=cfg.pallas_window_t,
                sub_len=cfg.capped_sub_len)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "profile_pallas")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("csf", nargs="?", type=float, default=1.25)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.csf, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
