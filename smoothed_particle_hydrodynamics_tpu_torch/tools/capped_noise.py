"""Density noise of the capped ("Subsets") mode against the exact oracle:
counterpart of ``tools/capped_noise.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.capped_noise \\
        [N] [K_c] [csf] [--device cpu]

Settles the splash (default 1M) for 10 steps with the EXACT lazy driver
(1.25h cells, window 208), so the state is the same whatever the dials,
then computes density on that state twice: the cell-list oracle
(``ops.step.compute_forces``, backend ``celllist``) and the capped sweep
(``ops.sweeps_t.prepare_t`` + ``density_sweep_t``) at the given K_c and
cell size, window and sub-frame bound derived from the settled state.  It
prints their relative L2 and the capped over exact mean density (the
reweighting's unbiasedness): the noise column behind the capped mode's
cell-size dial.
"""

from __future__ import annotations

import argparse

import torch

from ..models import make_scene
from ..ops import lazy, sweeps_t as pst
from ..ops.grid import unsort
from ..ops.step import compute_forces
from . import start


def main(n=1_000_000, k_c=4, csf=1.25, steps_settle=10, device="cuda"
         ) -> dict:
    dev = start(device)
    # settle with the EXACT driver so the state is the same across dials
    cfg0, state = make_scene("splash", device=dev, num_particles=n,
                             cell_size_factor=1.25, pallas_window_t=208)
    st = lazy.unsort_carry(lazy.drive_loop_lazy(
        cfg0, state, steps_settle, collect_diags=False, keep_carry=True)[0])

    _, rho_exact, _ = compute_forces(cfg0, st, backend="celllist")

    cfg, _ = make_scene("splash", device=dev, num_particles=n,
                        cell_size_factor=csf, capped_candidates=k_c,
                        pallas_window_t=0)
    cfg = cfg.replace(pallas_window_t=pst.derive_window_t(cfg, st))
    if cfg.capped_sub_len == 0:
        cfg = cfg.replace(capped_sub_len=pst.derive_sub_len(cfg, st))

    p = pst.prepare_t(cfg, st)
    rho_s, _ = pst.density_sweep_t(cfg, p)
    rho_c = unsort(p.order, rho_s)
    rc, re = rho_c.double(), rho_exact.double()
    l2 = float(torch.linalg.norm(rc - re) / torch.linalg.norm(re))
    ratio = float(rc.mean() / re.mean())
    print(f"n={n} K_c={k_c} csf={csf} window_t={cfg.pallas_window_t} "
          f"sub_len={cfg.capped_sub_len}")
    print(f"density rel-L2 vs exact: {l2:.4f}   mean ratio: {ratio:.4f}")
    return dict(rel_l2=l2, mean_ratio=ratio, window_t=cfg.pallas_window_t,
                sub_len=cfg.capped_sub_len)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "capped_noise")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("csf", nargs="?", type=float, default=1.25)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.csf, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
