"""Sub-phase times of ``prepare_t``, the lazy driver's rebuild: counterpart of
``tools/profile_prepare.py``.

    python -m \\
        smoothed_particle_hydrodynamics_tpu_torch.tools.profile_prepare \\
        [N] [K_c] [--device cpu]

Settles the capped splash (default 1M, K_c 4, 1.25h cells, window and
sub-frame bound derived; K_c 0 is exact) for 10 lazy steps, then rebuilds
the settled state's ``PreparedT`` out of ``ops/sweeps_t.py``'s own helpers,
timing each (host clock over 10 calls, ended by a device sync): the cell
ids, the (cell, hash) sort (``_capped_order``; exact's plain stable sort
beside it), the stacked [N, 7] field gather, the rank/occupancy scans
(``_run_rank_occ``), the sub frame (``_sub_frame``: those scans, the
kept-compaction sort and the sub-frame gathers; the line after it is its
time less the scans'), the candidates' cell-start table
(``cell_start_t``), the band ranges the twins read (``band_ranges``, not a
part of the rebuild) and ``prepare_t`` end to end.  ``compose`` is that rebuild; ``tests/test_torch_tools_profile.py``
holds it bit-equal to ``prepare_t``.
"""

from __future__ import annotations

import argparse

import torch

from ..models import make_scene
from ..ops import lazy, sweeps_t as pst
from ..ops.grid import cell_coords, linear_cell_id
from . import Phases, derive_settings, start


def compose(cfg, state, ph: Phases, iters: int = 10) -> pst.PreparedT:
    """``prepare_t(cfg, state)`` from its helpers, each timed by ``ph``."""
    n = state.n
    capped = bool(cfg.capped_candidates)
    cid = ph.host("cell ids",
                  lambda pos: linear_cell_id(cfg, cell_coords(cfg, pos)),
                  state.position, iters=iters)
    exact_sort = ph.host("pair sort (cid,iota)  [exact's]",
                         lambda c: torch.sort(c, stable=True), cid,
                         iters=iters)
    if capped:
        cid_sorted, order = ph.host("pair sort (cid,hash,iota)",
                                    pst._capped_order, cid,
                                    pst._hash_bits(cfg), iters=iters)
    else:
        cid_sorted, order = exact_sort
    stacked = ph.host(
        "stacked [N,7] field gather",
        lambda o: torch.cat([state.position, state.velocity,
                             state.mass[:, None]], dim=1)[o],
        order, iters=iters)
    mass_s = stacked[:, 6].contiguous()
    sub, cid_search = {}, cid_sorted
    if capped:
        ph.host("rank/occ scans", pst._run_rank_occ, cid_sorted, iters=iters)
        sub, cid_search = ph.host("sub frame (_sub_frame)", pst._sub_frame,
                                  cfg, cid_sorted, mass_s, iters=iters)
        ph.show("  compaction sort + gathers",
                ph.ms["sub frame (_sub_frame)"] - ph.ms["rank/occ scans"],
                "   (difference)")
    cell_start = ph.host("cell starts (bincount+cum)", pst.cell_start_t, cfg,
                         cid_search, iters=iters)
    p = pst.PreparedT(order=order, pos_s=stacked[:, 0:3].contiguous(),
                      vel_s=stacked[:, 3:6].contiguous(), mass_s=mass_s,
                      cid=cid_sorted.contiguous(), cell_start=cell_start,
                      **sub)
    ph.host("band ranges [N,9] (twins only)", pst.band_ranges, cfg, p.cid,
            cell_start, iters=iters)
    return p


def main(n=1_000_000, k_c=4, steps_settle=10, device="cuda",
         iters: int = 10) -> dict:
    dev = start(device)
    overrides = dict(num_particles=n, cell_size_factor=1.25,
                     capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **overrides)
    cfg = derive_settings(cfg, state)
    print(f"n={n} K_c={k_c} window_t={cfg.pallas_window_t} "
          f"sub_len={cfg.capped_sub_len}")
    carry, _ = lazy.drive_loop_lazy(cfg, state, steps_settle,
                                    collect_diags=False, keep_carry=True)
    st = carry.state
    ph = Phases(dev)
    composed = compose(cfg, st, ph, iters)
    ph.host("prepare_t end-to-end", pst.prepare_t, cfg, st, iters=iters)
    return dict(ms=ph.ms, composed=composed, cfg=cfg, state=st)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "profile_prepare")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
