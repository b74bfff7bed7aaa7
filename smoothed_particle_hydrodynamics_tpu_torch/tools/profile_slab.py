"""Per-step times of the slab engine on a one-rank group, steady against
rebin: counterpart of ``tools/profile_slab.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.profile_slab \\
        [N] [K_c] [csf] [steps] [grid_nz] [scan_block] [--phases] \\
        [--device cpu]

Steps the splash (default 1M, capped K_c 4 at 1.25h cells; K_c 0 is exact;
``grid_nz`` > 0 squeezes it into that many z planes, the strong-scaling
proxy) on the slab engine (``parallel.slabs``, the kernels' sweeps) over a
one-rank group of this device (NCCL on the card, gloo on the CPU), 10
calls to settle, then times each call (host clock ended by a device sync,
per step) and tags the calls in which a rebin fired, with the largest
drift since binning over the skin.  ``scan_block`` K > 1 takes K steps a
call; the port loops the same step K times (``parallel/slabs.py``), so it
amortizes nothing but the host's per-call work.

``--phases`` then times the same step with one stage replaced by a stub,
each from a copy of the settled carry: the density sweep, the force sweep,
both, the integration and its energy tally (frozen motion), and all of
them.  The stubs replace the mode's ``parallel.slab_sweeps`` callers
(exact, capped two-pass, or fused: the pre-pass and K3) and
``parallel.slabs.kdk_integrate`` while a variant runs.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch

from ..models import make_scene
from ..ops.integrate import EnergyTally
from ..ops.lazy import skin_half
from ..parallel import comm, slab_sweeps, slabs
from . import derive_settings, host_tag, start, steady_rebin, sync
from .ab_engines import slab_engine


def _trace(step, carry, steps, settle, dev, label="", skin=None, k=1):
    """Per-call timing loop (k steps a call); returns (carry, steady_ms,
    rebin_ms) per STEP.  A call is tagged REBIN if any of its k steps
    rebinned."""
    times, rebinned = [], []
    rb_prev = carry.rebin_count
    host = host_tag(dev)
    for i in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        carry, _ = step(carry)
        sync(dev)
        dt = (time.perf_counter() - t0) * 1000 / k
        fired = carry.rebin_count > rb_prev
        rb_prev = carry.rebin_count
        times.append(dt)
        rebinned.append(fired)
        if not label:
            note = ""
            if skin:        # post-step drift against the rebin skin
                f = carry.fields
                valid = f[:, 7] >= 0.0
                drift = float((f[:, 0:3] - carry.pos_bin)[valid].abs().max())
                note = f"  drift/skin {drift / skin:5.2f}"
            print(f"  step {settle + i:3d}  {dt:9.3f} ms{host}  "
                  f"{'REBIN' if fired else '     '}{note}")
    steady, rebin = steady_rebin(times, rebinned)
    print(f"{label or 'full step':28s} steady {steady:8.3f} ms  "
          f"rebin {rebin:8.3f} ms{host}  (rebins {sum(rebinned)}/{steps})",
          flush=True)
    return carry, steady, rebin


def _stubs(cfg, p_cap: int, dev) -> tuple[dict, dict, dict]:
    """(density stubs, force stubs, integration stub) by the names the
    slab step calls: the mode's ``slab_sweeps`` callers and ``kdk_integrate``.
    The sweeps' stubs return ρ = 1, no neighbours, no acceleration."""
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(
        dtype=torch.int32, device=dev)

    def dens(*a, **k):
        return torch.ones(p_cap, **f32), torch.zeros(p_cap, **i32)

    def force(*a, **k):
        return torch.zeros(p_cap, 3, **f32)

    def pre(cfg_, g8, *a, **k):
        return torch.ones(g8.shape[0], **f32)

    def fused(*a, **k):
        return force(), *dens()

    def kdk(cfg_, st, acc):
        z = torch.zeros((), **f32)
        return st._replace(acceleration=acc), EnergyTally(
            z, z, z, torch.zeros(3, **f32))

    if not cfg.capped_candidates:
        d, f = {"density_local": dens}, {"force_local": force}
    elif cfg.capped_fused:
        d, f = {"density_sub_local": pre}, {"fused_local_capped": fused}
    else:
        d, f = ({"density_local_capped": dens},
                {"force_local_capped": force})
    return d, f, {"kdk_integrate": kdk}


@contextlib.contextmanager
def _patched(patches: dict):
    """Replace the slab step's callees by name while the block runs."""
    saved = {}
    try:
        for name, fn in patches.items():
            mod = slabs if name == "kdk_integrate" else slab_sweeps
            saved[name] = (mod, getattr(mod, name))
            setattr(mod, name, fn)
        yield
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)


def _copy(carry):
    return carry._replace(fields=carry.fields.clone())


def main(n=1_000_000, k_c=4, csf=1.25, steps=24, settle=10, phases=False,
         grid_nz=0, scan_block=0, device="cuda") -> dict:
    dev = start(device)
    ov = dict(num_particles=n, cell_size_factor=csf)
    if grid_nz:
        # the slab-proxy geometry: n in a grid_nz-plane box is one rank of
        # a 128 // grid_nz-rank run
        ov["grid_nz"] = grid_nz
    if k_c:
        ov.update(capped_candidates=k_c, pallas_window_t=0)
    cfg, state = make_scene("splash", device=dev, **ov)
    cfg = derive_settings(cfg, state)
    k = max(scan_block, 1)
    out = {}
    with comm.local_group(dev) as group:
        carry, step, (p_cap, h_cap, m_cap), sub_len = slab_engine(
            cfg, state, group, scan_block=scan_block)
        print(f"n={n} K_c={k_c} csf={csf} grid_nz={grid_nz} sb={scan_block} "
              f"window_t={cfg.pallas_window_t} "
              f"p_cap={p_cap} h_cap={h_cap} m_cap={m_cap} sub_len={sub_len} "
              f"device={dev}")
        for _ in range(settle):          # settle into mid-splash
            carry, _ = step(carry)
        sync(dev)
        carry, *out["full step"] = _trace(step, carry, steps, settle, dev,
                                          skin=skin_half(cfg), k=k)
        if phases:
            dens, force, kdk = _stubs(cfg, p_cap, dev)
            variants = [
                ("no density sweep", dens),
                ("no force sweep", force),
                ("no sweeps at all", {**dens, **force}),
                ("no kdk+tally (frozen motion)", kdk),
                ("machinery only (all stubbed)", {**dens, **force, **kdk}),
            ]
            for label, patches in variants:
                with _patched(patches):
                    cv = _copy(carry)
                    for _ in range(3):
                        cv, _ = step(cv)
                    sync(dev)
                    _, *out[label] = _trace(step, cv, max(steps // 2, 8),
                                            settle, dev, label=label, k=k)
    return dict(steady_rebin_ms=out, caps=(p_cap, h_cap, m_cap),
                sub_len=sub_len)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "profile_slab")
    ap.add_argument("n", nargs="?", type=int, default=1_000_000)
    ap.add_argument("k_c", nargs="?", type=int, default=4)
    ap.add_argument("csf", nargs="?", type=float, default=1.25)
    ap.add_argument("steps", nargs="?", type=int, default=24)
    ap.add_argument("grid_nz", nargs="?", type=int, default=0)
    ap.add_argument("scan_block", nargs="?", type=int, default=0)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.k_c, a.csf, a.steps, phases=a.phases, grid_nz=a.grid_nz,
         scan_block=a.scan_block, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
