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
probe's main routine.  This module holds what the three share: the library, the
timer (CUDA events around launches that are already queued behind a sleep
on the card, so a kernel shorter than its host call is timed, not the
host), the error measure and the card's peaks and issue rates
(``chip_smoke.py`` reads the same timer, error measure and peaks).
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import time

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
