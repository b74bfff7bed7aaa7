"""A/B the single-device lazy step against the one-rank slab step:
counterpart of ``tools/ab_engines.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.ab_engines \\
        [N] [K_c] [steps] [--device cpu]

Both engines step the same splash (default 8192 particles, capped K_c 4 at
1.25h cells; K_c 0 is exact) with the same kept-set policy, so their
trajectories should agree to f32 noise: the lazy driver
(``ops.lazy.lazy_step``) and the slab engine on a one-rank group of this
device (``parallel.comm.local_group``: NCCL on the card, gloo on the CPU;
``parallel.slabs``: ``derive_zsplit``, ``derive_slab_caps`` at headroom
1.05, ``derive_sub_len_slab``, ``distribute``, ``make_slab_step`` with the
kernels' sweeps).  Each step prints both engines' largest per-particle
displacement in skin units with an ``R`` where that engine rebinned, the
positions' rel-L2 between them (slab rows mapped back to original ids
through field 7) and the slab's valid rows.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models import make_scene
from ..ops import lazy
from ..parallel import comm, slabs
from ..utils.benchmark import slab_sizes
from . import derive_settings, start


def slab_engine(cfg, state, group, sweeps: str = "pallas",
                scan_block: int = 0, headroom: float = 1.05):
    """(carry, step, (p_cap, h_cap, m_cap), sub_len): the slab engine on
    ``group`` (one rank) as ``utils.benchmark.slab_setup`` sizes it."""
    zsplit, caps, sub_len = slab_sizes(cfg, state, headroom)
    carry = slabs.distribute(cfg, state, group, caps[0], zsplit=zsplit)
    step = slabs.make_slab_step(cfg, group, *caps, sweeps=sweeps,
                                zsplit=zsplit, sub_len=sub_len,
                                scan_block=scan_block)
    return carry, step, caps, sub_len


def slab_positions(fields, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(positions [n, 3] by original id, valid-row mask) of a slab store:
    field 7 holds each row's original id, -1 on an empty row."""
    f = fields.detach().cpu().numpy()
    valid = f[:, 7] >= 0.0
    pos = np.zeros((n, 3), np.float32)
    pos[f[valid, 7].astype(np.int64)] = f[valid, 0:3]
    return pos, valid


def main(n=8192, k_c=4, steps=24, device="cuda") -> dict:
    dev = start(device)
    ov = dict(num_particles=n, cell_size_factor=1.25)
    if k_c:
        ov.update(capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **ov)
    cfg = derive_settings(cfg, state)
    skin = lazy.skin_half(cfg)
    print(f"n={n} K_c={k_c} skin={skin:.6f} window_t={cfg.pallas_window_t} "
          f"device={dev}")

    carry = lazy.init_lazy(cfg, state)
    rel_l2, rebins1, rebins2 = [], [], []
    with comm.local_group(dev) as group:
        scarry, step2, _, _ = slab_engine(cfg, state, group)
        prev1 = prev2 = None
        rb1p = rb2p = 0
        for i in range(steps):
            carry, _ = lazy.lazy_step(cfg, carry)
            scarry, _ = step2(scarry)
            # single-device positions in ORIGINAL order
            p1 = lazy.unsort_carry(carry).position.cpu().numpy()
            p2, valid = slab_positions(scarry.fields, state.n)
            rel = float(np.linalg.norm(p1 - p2)
                        / max(np.linalg.norm(p1), 1e-30))
            d1 = np.abs(p1 - prev1).max() / skin if prev1 is not None else 0.0
            d2 = np.abs(p2 - prev2).max() / skin if prev2 is not None else 0.0
            rb1, rb2 = carry.rebin_count, scarry.rebin_count
            print(f"step {i:3d}  d1/skin {d1:5.2f}"
                  f"{' R' if rb1 > rb1p else '  '}"
                  f"  d2/skin {d2:5.2f}{' R' if rb2 > rb2p else '  '}"
                  f"  relL2 {rel:.3e}  nvalid {int(valid.sum())}")
            rel_l2.append(rel)
            rebins1.append(rb1 > rb1p)
            rebins2.append(rb2 > rb2p)
            prev1, prev2, rb1p, rb2p = p1, p2, rb1, rb2
    return dict(rel_l2=rel_l2, rebinned_single=rebins1,
                rebinned_slab=rebins2)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "ab_engines")
    ap.add_argument("n", nargs="?", type=int, default=8192)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("steps", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.steps, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
