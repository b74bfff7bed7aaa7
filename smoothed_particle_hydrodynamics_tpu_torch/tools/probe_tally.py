"""Formulations of the energy tally's reductions, fused with the update:
counterpart of ``tools/probe_tally.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_tally \\
        [N] [--device cpu]

On the splash's N (1M) particles, the kick-drift-kick update followed by
the KE, PE and |L| reductions in the JAX tool's five shapes (three separate
sums, one sum of a stacked [N, 5], a two-stage sum over 4096-row blocks,
``ones @ cols``, flat per-column sums) and ``kdk_integrate`` itself (the
production reference point, which sums the stacked [N, 5]).  Each is the
JAX tool's ``bench``: one call off the clock, then 20 on the host clock
ended by a device sync.  These are PyTorch reductions being compared, not a
kernel: each formulation is a handful of library launches.
"""

from __future__ import annotations

import argparse

import torch

from ..config import _f32
from ..models import make_scene
from ..ops.integrate import kdk_integrate
from . import Phases, start
from .probe_dispatch import kdk_no_tally

ITERS = 20
BLOCK = 4096     # the two-stage sum's block


def tally_terms(cfg, pos, vel, mass):
    """Per-particle KE, PE and L (the JAX tool's ``tally_terms``)."""
    center = torch.tensor(cfg.central_pos, dtype=torch.float32,
                          device=pos.device)
    rel = (pos - center) * _f32(cfg.sim_scale)
    dist = torch.sqrt((rel * rel).sum(-1))
    v2 = (vel * vel).sum(-1)
    ke_i = torch.where(torch.isfinite(v2), 0.5 * mass * v2,
                       torch.zeros_like(v2))
    gm = _f32(_f32(cfg.grav_constant) * _f32(cfg.central_mass))
    pe_i = gm * mass / (dist + _f32(cfg.softening_eff))
    l_i = mass[:, None] * torch.linalg.cross(rel, vel)
    return ke_i, pe_i, l_i


def _cols(cfg, st, acc):
    pos, vel = kdk_no_tally(cfg, st, acc)
    ke_i, pe_i, l_i = tally_terms(cfg, pos, vel, st.mass)
    return pos, vel, torch.cat([ke_i[:, None], pe_i[:, None], l_i], dim=1)


def _result(pos, vel, s):
    return pos, vel, s[0], -s[1], torch.linalg.norm(s[2:5])


def v_current(cfg, st, acc):
    pos, vel = kdk_no_tally(cfg, st, acc)
    ke_i, pe_i, l_i = tally_terms(cfg, pos, vel, st.mass)
    return (pos, vel, ke_i.sum(), -pe_i.sum(),
            torch.linalg.norm(l_i.sum(0)))


def v_stacked(cfg, st, acc):
    pos, vel, cols = _cols(cfg, st, acc)
    return _result(pos, vel, cols.sum(0))


def v_twostage(cfg, st, acc):
    pos, vel, cols = _cols(cfg, st, acc)
    cols = torch.nn.functional.pad(cols, (0, 0, 0, (-cols.shape[0]) % BLOCK))
    return _result(pos, vel, cols.view(-1, BLOCK, 5).sum(1).sum(0))


def v_dot(cfg, st, acc):
    pos, vel, cols = _cols(cfg, st, acc)
    ones = torch.ones(cols.shape[0], dtype=torch.float32, device=cols.device)
    return _result(pos, vel, ones @ cols)


def v_flat(cfg, st, acc):
    pos, vel = kdk_no_tally(cfg, st, acc)
    ke_i, pe_i, l_i = tally_terms(cfg, pos, vel, st.mass)
    lx, ly, lz = l_i[:, 0].sum(), l_i[:, 1].sum(), l_i[:, 2].sum()
    return (pos, vel, ke_i.sum(), -pe_i.sum(),
            torch.sqrt(lx * lx + ly * ly + lz * lz))


def v_production(cfg, st, acc):
    new, t = kdk_integrate(cfg, st, acc)
    return new.position, new.velocity, t.kinetic, t.potential, \
        t.angular_momentum


VARIANTS = {
    "kdk + tally (current shape)": v_current,
    "kdk + tally stacked [N,5] sum": v_stacked,
    "kdk + tally two-stage blocked": v_twostage,
    "kdk + tally ones@cols (matmul)": v_dot,
    "kdk + tally flat per-column sums": v_flat,
    "kdk production (reference point)": v_production,
}


def main(n=1_000_000, device="cuda", iters=ITERS) -> dict:
    dev = start(device)
    cfg, state = make_scene("splash", device=dev, num_particles=n)
    acc = torch.zeros_like(state.position)
    print(f"n={n} device={dev}")
    ph = Phases(dev, width=44)
    out = {name: ph.host(name, fn, cfg, state, acc, iters=iters)
           for name, fn in VARIANTS.items()}
    return dict(ms=ph.ms, values={name: [float(v) for v in o[2:]]
                                  for name, o in out.items()})


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "probe_tally")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
