"""Hardware probes of the card: counterparts of the JAX package's TPU probes
in ``tools/`` (``probe_vpu_ops.py``, ``probe_gather.py``, ``probe_mxu.py``),
each asking its question of an NVIDIA Hopper GPU.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_vpu_ops
    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_gather
    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_mxu

Each runs on the card (``cuda``) and stops when there is none; ``--device
cpu`` runs the plain PyTorch versions at small sizes, with host times.  The
kernels live in ``csrc/probes.cu`` (built on first use, like the sweeps);
each module holds a kernel's counted wrapper, its plain version and the
probe's main routine.  ``probe_dma_floor`` (kernels in ``csrc/floor_t.cu``)
splits a sweep's time into staged bytes, the walk and the arithmetic, on
the JAX probe's window walk and on the port's band walk; ``probe_cond``,
``probe_scan``, ``probe_dispatch`` and ``probe_tally`` have no kernel and
time the step's host side (the drift test's read, K frozen steps as one
CUDA graph, launches, the tally's reductions), with the study tools'
conventions below.  This module holds what the three share: the library, the
timer (CUDA events around launches that are already queued behind a sleep
on the card, so a kernel shorter than its host call is timed, not the
host), the error measure and the card's peaks and issue rates
(``chip_smoke.py`` reads the same timer, error measure and peaks).

The study tools, counterparts of the JAX package's other ``tools/`` with
the same file names, drive the port's step to answer questions about it:
``capped_fullrun`` (the capped mode's full-run record), ``capped_noise``,
``trace_drift``, ``ab_engines``, ``profile_pallas``, ``profile_prepare``,
``profile_lazy``, ``profile_slab``, ``profile_step`` (the cell-list step by
phase; ``utils/profile_step.py`` is the ``torch.profiler`` trace),
``ab_dials``, ``ab_slab`` and ``microbench``.  Each takes the JAX tool's
positional arguments, in its order and with its defaults, plus
``--device`` (default ``cuda``; with no card it stops with the reason,
``--device cpu`` runs it at small sizes for the tests, its times labelled
host times), prints the card's name and power limit on its first line, and
times on the host clock around ``torch.cuda.synchronize()`` (``Phases``),
a phase that is one launch by queued CUDA events (``time_ms``).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import time

import numpy as np
import torch

from ..utils import build

# H100 SXM published peaks: HBM bytes/s, f32 FLOP/s outside the tensor
# cores, dense TF32 tensor-core FLOP/s
HBM_BYTES_PER_S, F32_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 495e12
# results per clock per SM, compute capability 9.0 (CUDA C Programming
# Guide, arithmetic instruction throughput): f32 add/mul/fma; the
# multi-function unit (reciprocal, reciprocal square root, ...); 32-bit
# integer add, compare, logic and shift; and lane-instructions of any kind
# (4 schedulers issuing one warp instruction a clock each)
FP32_PER_CLK, MUFU_PER_CLK, INT_PER_CLK, ISSUE_PER_CLK = 128, 16, 64, 128


@functools.cache
def kernels() -> ctypes.CDLL:
    """Build (first use) and bind ``csrc/probes.cu``."""
    lib = build.load_library("probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_chain.argtypes = [p, p, ctypes.c_longlong, i, i, p]
    lib.probe_chain.restype = i
    lib.probe_gather_tile.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    lib.probe_gather_tile.restype = i
    lib.probe_d2_tile.argtypes = [p, p, p, p, i, i, p]
    lib.probe_d2_tile.restype = i
    lib.sph_error_string.argtypes = [i]
    lib.sph_error_string.restype = ctypes.c_char_p
    return lib


def resolve_device(device) -> torch.device:
    """The probes' device: cuda (the default; raises when there is no
    card) or cpu (the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes measure the card "
                           "(--device cpu runs the plain versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"probes run on cuda or cpu, not {dev}")
    return dev


SLEEP_MS, SLEEP_MAX_MS = 2.0, 100.0


def timing(fn, device="cuda", iters: int = 20, warmup: int = 3) -> dict:
    """Mean ms of ``fn`` over ``iters`` runs after ``warmup`` (``ms``):
    CUDA events on the card, the host clock on the CPU.

    On the card the stream first sleeps (``torch.cuda._sleep``) for 1.5x
    the host time of the ``iters`` calls, as the last warmup call took it,
    and at least ``SLEEP_MS``, at most ``SLEEP_MAX_MS``; only then is the
    start event recorded.  So the timed launches are already queued when
    the first one runs, and the events time the card, not the host's
    enqueue.  ``enqueue_ms`` is the host's time for the ``iters`` calls,
    ``sleep_ms`` the sleep on the card, and ``covered`` says that the
    start event had not yet run when the last call was enqueued."""
    device = torch.device(device)
    call_ms = SLEEP_MS
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        call_ms = (time.perf_counter() - t0) * 1e3
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return dict(ms=(time.perf_counter() - t0) / iters * 1e3)
    torch.cuda.synchronize(device)
    before = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep = min(max(1.5 * iters * call_ms, SLEEP_MS), SLEEP_MAX_MS)
    before.record()
    torch.cuda._sleep(int(sleep * 1e-3 * card(device.index or 0)["clock_hz"]))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    covered = not start.query()
    end.record()
    torch.cuda.synchronize(device)
    return dict(ms=start.elapsed_time(end) / iters, enqueue_ms=enqueue_ms,
                sleep_ms=before.elapsed_time(start), covered=covered)


def time_ms(fn, device="cuda", iters: int = 20, warmup: int = 3) -> float:
    """``timing(...)["ms"]``: mean ms a run of ``fn``."""
    return timing(fn, device, iters, warmup)["ms"]


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|, in f64."""
    return (a.double() - b.double()).abs().max().item()


@functools.cache
def card(index: int = 0) -> dict:
    """The card's name, SM count and maximum SM clock (Hz), as the run
    reads them (``nvidia-smi`` for the clock)."""
    props = torch.cuda.get_device_properties(index)
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return dict(name=props.name, sms=props.multi_processor_count,
                clock_hz=float(out.stdout.strip()) * 1e6)


def bound(nbytes: int, ops_ms: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations' own least time."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= ops_ms
            else (ops_ms, "operations"))


# ---------------------------------------------------------------------------
# The study tools' shared pieces
# ---------------------------------------------------------------------------

def tool_device(device) -> torch.device:
    """The study tools' device: cuda (the default) or cpu.  With no card
    the tool stops (``SystemExit``: exit status 1 and the reason) instead
    of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card "
                         "(--device cpu runs it on the host at small sizes, "
                         "with host times)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"the tools run on cuda or cpu, not {dev}")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them; on the CPU a note
    that every time is a host time."""
    if dev.type != "cuda":
        return "cpu (host times, not the card's)"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def start(device) -> torch.device:
    """A tool's first step: resolve ``device`` (``tool_device``) and print
    ``card_line`` as the first line of the output."""
    dev = tool_device(device)
    print(card_line(dev), flush=True)
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the card (nothing on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host_tag(dev: torch.device) -> str:
    """What follows a time taken on ``dev``: ``" host"`` on the CPU."""
    return "" if dev.type == "cuda" else " host"


def derive_settings(cfg, state):
    """The JAX tools' two derivations from the scene's state:
    ``pallas_window_t`` 0 from its rod windows, and in capped mode
    ``capped_sub_len`` 0 from its occupancy."""
    from ..ops import sweeps_t

    if cfg.pallas_window_t == 0:
        cfg = cfg.replace(
            pallas_window_t=sweeps_t.derive_window_t(cfg, state))
    if cfg.capped_candidates and cfg.capped_sub_len == 0:
        cfg = cfg.replace(capped_sub_len=sweeps_t.derive_sub_len(cfg, state))
    return cfg


def steady_rebin(times, rebinned, stat=np.mean) -> tuple[float, float]:
    """(steady, rebin): ``stat`` of the step times without and with a
    rebin (NaN where there is none)."""
    t, m = np.asarray(times), np.asarray(rebinned, dtype=bool)
    return (float(stat(t[~m])) if (~m).any() else float("nan"),
            float(stat(t[m])) if m.any() else float("nan"))


class Phases:
    """Times of a tool's phases (ms by name, in ``ms``), each printed as
    the JAX tools print theirs (``name  ms``), with ``host`` after it on
    the CPU."""

    def __init__(self, dev: torch.device, width: int = 34):
        self.dev, self.width, self.ms = dev, width, {}

    def show(self, name: str, ms: float, note: str = "") -> None:
        self.ms[name] = ms
        print(f"{name:{self.width}s} {ms:9.3f} ms{host_tag(self.dev)}{note}",
              flush=True)

    def host(self, name: str, fn, *args, iters: int = 10):
        """The JAX tools' ``bench``: one call off the clock (it builds what
        the first call builds), then ``iters`` calls on the host clock,
        ended by a device sync; returns the last call's output."""
        out = fn(*args)
        sync(self.dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync(self.dev)
        self.show(name, (time.perf_counter() - t0) / iters * 1e3)
        return out

    def events(self, name: str, fn, *args, iters: int = 20):
        """A phase that is one launch: ``time_ms``'s queued CUDA events (the
        host clock on the CPU); returns one call's output."""
        self.show(name, time_ms(lambda: fn(*args), self.dev, iters))
        return fn(*args)
