"""Host-side helpers shared by the kernel wrappers (``sweeps_t``,
``sweeps_lane``, ``parallel/slab_sweeps``, the probes in ``tools/``): which
path a tensor takes, argument checks, launch errors.

A wrapper given CPU tensors computes with its plain PyTorch twin; given
CUDA tensors it launches its kernel or raises; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch


def use_plain(x: torch.Tensor) -> bool:
    """CPU tensors take the twin, CUDA tensors the kernel; nothing else."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"the kernels run on cuda (twin on cpu), got a "
                     f"tensor on {x.device}")


def check(device: torch.device, **specs) -> None:
    """Each spec is (tensor, dtype, shape): the kernels take contiguous
    tensors on one device, of exactly these types and shapes."""
    for name, (t, dtype, shape) in specs.items():
        if (t.device != device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(
                f"{name}: need a contiguous {dtype} tensor of shape {shape} "
                f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def raise_on(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({lib.sph_error_string(err).decode()})")


def stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream
