"""K frozen steps a dispatch: counterpart of ``tools/probe_scan.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_scan \\
        [n] [scene] [--device cpu]

The JAX tool asks whether a ``lax.scan`` of K lazy steps in one call
amortizes the per-call overhead at small n.  The port's counterpart of one
call holding K steps is one CUDA graph replay: K = 8 of
``probe_cond.frozen_step`` (the lazy step's frozen path, no drift test, no
host read) captured once as a ``torch.cuda.CUDAGraph`` and replayed, with
the per-step diagnostics stacked into [K] tensors (``diag ys``) and without
(eager PyTorch computes them either way: only the stacking goes), against
the production host loop (``ops.lazy.lazy_step``, rebinning when its drift
test asks).  Defaults are the JAX tool's: the 32k disk (``1000000 splash``
is its other case), 1.25h cells, window derived; 2K settling steps, then 6
rounds of K steps each way, in ms a step (host clock, ended by a device
sync).

A graph cannot rebin: it replays its frozen tables.  So each graph starts
from a fresh binning of the current state, records each step's drift spread
(the quantity ``lazy_step`` tests) and, before anything is timed, one replay
is checked: if any of its K steps would have rebinned, the probe says so.
The timed replays keep the largest spread in the graph, and the probe
reports whether it passed the rebin threshold.

Capture.  ``torch.tensor(values, device=cuda)`` copies from pageable host
memory and synchronizes, which a capture refuses; the step makes its
config vectors so (``sweeps_sorted``'s gravity and ``central_gravity``'s
centre; the integrator's kernel takes its box and centre as arguments).
``DeviceConstants`` serves them, inside the capture, from one tensor each
made by the warm-up run before it; the step's code is unchanged.  Nothing
else in the frozen step reads the card from the host.  With ``--device
cpu`` the K steps run as a loop, labelled host.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..config import _f32
from ..models import make_scene
from ..ops import lazy
from ..ops import sweeps_t as pst
from ..state import stack_diagnostics
from . import host_tag, start, sync
from .probe_cond import frozen_step

K = 8
ROUNDS = 6


class DeviceConstants:
    """Inside ``with``: ``torch.tensor(list or tuple, device=cuda, ...)``
    returns one tensor per (values, dtype, device), made at its first call
    (outside a capture) and served again after, so a CUDA graph capture
    replays it instead of copying from the host."""

    def __init__(self):
        self.cache = {}
        self._orig = None

    def __enter__(self):
        orig = self._orig = torch.tensor
        cache = self.cache

        def tensor(data, *args, **kw):
            dev = kw.get("device")
            if (args or dev is None or torch.device(dev).type != "cuda"
                    or not isinstance(data, (list, tuple))):
                return orig(data, *args, **kw)
            key = (tuple(data), kw.get("dtype"), str(dev))
            if key not in cache:
                cache[key] = orig(data, **kw)
            return cache[key]

        torch.tensor = tensor
        return self

    def __exit__(self, *exc):
        torch.tensor = self._orig


def threshold(cfg) -> float:
    """The drift spread above which ``lazy_step`` rebins."""
    return float(_f32(2.0 * lazy.skin_half(cfg)))


def k_steps(cfg, carry: lazy.LazyCarry, k: int = K, ys: bool = True):
    """(carry, spreads [k], diagnostics): ``k`` frozen steps, each step's
    drift spread taken first, as ``lazy_step`` tests it; the diagnostics
    stacked into [k] tensors with ``ys``, else None."""
    spreads, diags = [], []
    for _ in range(k):
        spreads.append(lazy.drift_spread(carry.state.position,
                                         carry.pos_bin))
        carry, d = frozen_step(cfg, carry)
        diags.append(d)
    return carry, torch.stack(spreads), (stack_diagnostics(diags) if ys
                                         else None)


def rebinned(cfg, carry: lazy.LazyCarry) -> lazy.LazyCarry:
    """A fresh binning of the carry's state (drift spread 0)."""
    return lazy._bin(cfg, carry.state, carry.order, 0, carry.rebin_count + 1)


def load(dst: lazy.LazyCarry, src: lazy.LazyCarry) -> None:
    """Copy every tensor of ``src`` into ``dst``'s (same shapes)."""
    for a, b in zip([*dst.state, *dst[1:]], [*src.state, *src[1:]]):
        if isinstance(a, torch.Tensor) and a is not b:
            a.copy_(b)


class Replay:
    """``k_steps`` captured once as a CUDA graph over a static carry: each
    ``replay()`` runs the K steps from the carry's state and writes the
    final state back into it; ``spreads`` holds the last replay's drift
    spreads and ``peak`` the largest since ``reset``."""

    def __init__(self, cfg, carry: lazy.LazyCarry, k: int, ys: bool):
        self.cfg, self.k = cfg, k
        self.carry = rebinned(cfg, carry)
        self.consts = DeviceConstants()
        self.peak = torch.zeros((), dtype=torch.float32,
                                device=carry.state.position.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with self.consts, torch.cuda.stream(side):
            self._body(ys)                          # warm-up, uncaptured
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with self.consts, torch.cuda.graph(self.graph):
            self.spreads, self.diags = self._body(ys)
        self.reset()

    def _body(self, ys: bool):
        c, spreads, diags = k_steps(self.cfg, self.carry, self.k, ys)
        load(self.carry, c)
        self.peak.copy_(torch.maximum(self.peak, spreads.max()))
        return spreads, diags

    def reset(self) -> None:
        """A fresh binning of the static state, the peak cleared."""
        load(self.carry, rebinned(self.cfg, self.carry))
        self.peak.zero_()

    def replay(self) -> None:
        self.graph.replay()


def main(n=32768, scene="disk", k=K, rounds=ROUNDS, device="cuda") -> dict:
    dev = start(device)
    cfg, state = make_scene(scene, device=dev, num_particles=n,
                            cell_size_factor=1.25, pallas_window_t=0)
    cfg = cfg.replace(pallas_window_t=pst.derive_window_t(cfg, state))
    print(f"n={n} scene={scene} window_t={cfg.pallas_window_t} "
          f"device={dev}", flush=True)
    host = host_tag(dev)
    carry = lazy.init_lazy(cfg, state)
    for _ in range(2 * k):                       # settle
        carry, _ = lazy.lazy_step(cfg, carry)
    sync(dev)
    rb0 = carry.rebin_count
    t0 = time.perf_counter()
    for _ in range(rounds * k):
        carry, _ = lazy.lazy_step(cfg, carry)
    sync(dev)
    out = {"host loop": (time.perf_counter() - t0) / (rounds * k) * 1e3}
    print(f"{'host loop':34s} {out['host loop']:8.3f} ms/step{host} "
          f"({carry.rebin_count - rb0} rebins in {rounds * k} steps)")
    thr, checks = threshold(cfg), {}
    for ys in (True, False):
        name = (f"{'graph' if dev.type == 'cuda' else 'loop'} K={k}, "
                + ("diag ys" if ys else "no ys"))
        if dev.type == "cuda":
            g = Replay(cfg, carry, k, ys)
            g.replay()
            first = g.spreads.cpu()
            g.reset()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(rounds):
                g.replay()
            sync(dev)
            peak = float(g.peak)
        else:
            c = rebinned(cfg, carry)
            first = k_steps(cfg, c, k, ys)[1]
            c = rebinned(cfg, carry)
            t0 = time.perf_counter()
            peaks = []
            for _ in range(rounds):
                c, spreads, _ = k_steps(cfg, c, k, ys)
                peaks.append(float(spreads.max()))
            peak = max(peaks)
        ms = (time.perf_counter() - t0) / (rounds * k) * 1e3
        over = [i for i, s in enumerate(first.tolist()) if s > thr]
        if over:
            print(f"{name}: the checked replay's steps {over} would have "
                  f"rebinned (drift spread above {thr:.6f})")
        out[name] = ms
        checks[name] = dict(first_over=over, peak=peak,
                            peak_over=peak > thr)
        print(f"{name:34s} {ms:8.3f} ms/step{host}; largest drift spread "
              f"{peak:.6f} of the rebin threshold {thr:.6f}"
              + (" (a rebin would have fired in the timed steps)"
                 if peak > thr else ""))
    return dict(ms=out, checks=checks, threshold=thr, window_t=
                cfg.pallas_window_t)


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "probe_scan")
    ap.add_argument("n", nargs="?", type=int, default=32768)
    ap.add_argument("scene", nargs="?", default="disk")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(a.n, a.scene, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
