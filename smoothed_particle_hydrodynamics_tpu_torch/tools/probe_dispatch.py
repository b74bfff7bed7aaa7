"""What a launch costs, and where the integrator's time goes: counterpart of
``tools/probe_dispatch.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_dispatch \\
        [N] [--device cpu]

On the splash's N (1M) positions: one elementwise op, one reduction, a
10-op elementwise chain and 8 dependent reduce-and-broadcast barriers, then
``kdk_integrate`` whole and with its pieces turned off (``boundary=none``,
``second_kick=none``, the update without the energy tally, the tally
alone).  Each is the JAX tool's ``bench``: one call off the clock, then 20
on the host clock ended by a device sync, so the time holds the host's
dispatch as well as the card's work.  In eager PyTorch every op is its own
launch: the 10-op chain is 10 launches (XLA fused it into one) and the
barriers 8 x 3; comparing them with the single op at the same bytes says
whether a step of many small kernels is bound by dispatch.
"""

from __future__ import annotations

import argparse

import torch

from ..config import _f32
from ..models import make_scene
from ..ops.integrate import energy_tally, kdk_integrate, reflect_boundary
from ..ops.physics import central_gravity
from . import Phases, start

ITERS = 20
SPLASH_N = 1_000_000
ONE_LAUNCH = "x + 1  (one launch)"


def chain10(x: torch.Tensor) -> torch.Tensor:
    for _ in range(10):
        x = x * 1.0000001 + 1e-9
    return x


def barriers8(x: torch.Tensor) -> torch.Tensor:
    for _ in range(8):
        x = x + x.sum() * 1e-20
    return x


def kdk_no_tally(cfg, st, acc):
    """The JAX tool's kdk without the tally: kick, drift, central-gravity
    kick, reflect."""
    dt = _f32(cfg.dt)
    pos_dt = _f32(dt * _f32(1.0 / cfg.sim_scale))
    v_half = st.velocity + acc * _f32(dt * 0.5)
    new_pos = st.position + v_half * pos_dt
    new_vel = v_half + central_gravity(cfg, new_pos) * dt
    return reflect_boundary(cfg, st.position, new_pos, new_vel)


def variants(cfg, state, acc) -> dict:
    """label -> call: the probe's programs on ``state``."""
    x = state.position
    return {
        ONE_LAUNCH: lambda: x + 1.0,
        "sum(x)  (one reduce)": lambda: x.sum(),
        "10-op elementwise chain (10 launches)": lambda: chain10(x),
        "8 reduce barriers (24 launches)": lambda: barriers8(x),
        "kdk full": lambda: kdk_integrate(cfg, state, acc),
        "kdk boundary=none": lambda: kdk_integrate(
            cfg.replace(boundary="none"), state, acc),
        "kdk second_kick=none": lambda: kdk_integrate(
            cfg.replace(second_kick="none"), state, acc),
        "kdk without tally": lambda: kdk_no_tally(cfg, state, acc),
        "energy_tally alone": lambda: energy_tally(
            cfg, x, state.velocity, state.mass),
    }


def main(n=SPLASH_N, device="cuda", iters=ITERS) -> dict:
    dev = start(device)
    cfg, state = make_scene("splash", device=dev, num_particles=n)
    acc = torch.zeros_like(state.position)
    print(f"n={n} device={dev}")
    ph = Phases(dev, width=40)
    for name, fn in variants(cfg, state, acc).items():
        ph.host(name, fn, iters=iters)
    return dict(ms=ph.ms)


def one_launch_ms(n=SPLASH_N, device="cuda", iters=ITERS) -> float:
    """The probe's first program alone (``ONE_LAUNCH``), timed as ``main``
    times it: the host cost of one launch, with its device work."""
    dev = torch.device(device)
    cfg, state = make_scene("splash", device=dev, num_particles=n)
    ph = Phases(dev, width=40)
    ph.host(ONE_LAUNCH, variants(cfg, state, None)[ONE_LAUNCH], iters=iters)
    return ph.ms[ONE_LAUNCH]


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "probe_dispatch")
    ap.add_argument("n", nargs="?", type=int, default=SPLASH_N)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
