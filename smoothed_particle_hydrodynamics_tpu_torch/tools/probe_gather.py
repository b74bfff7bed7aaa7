"""Cost of a per-lane row gather inside a kernel on the card: counterpart of
``tools/probe_gather.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_gather \\
        [--device cpu]

The question (the TPU's in-kernel compaction of rod windows for capped mode,
closed there when the gather's lowering crashed): can the capped sweep
compact a rod window [S, 128] -> [C, 128] with one gather per element?  Only
worth it if the gather costs about what an elementwise pass does.  For each
window height S in 128 ... 1920 (about 4M f32 elements in nb blocks of
[S, 128]) it times, with queued CUDA events (``tools.time_ms``, 3 warmup
+ 20 timed runs, each on the next of ``COPIES`` copies of its inputs, so
that the bytes come from device memory and not from the 50 MB L2):

- ``ew``: 2x + 1; ``chain``: 12 steps of x * 1.0001 + 0.5;
- ``gather_smem``: out[r, l] = src[idx[r, l], l] from each block's column
  strip [S, w] in shared memory: persistent CTAs, each strip loaded by TMA
  into a ring of 2-3 buffers while the last one gathers (w = 32 up to
  S = 512, 16 at 1024, 8 at 1920: two strips must fit);
- ``gather_global``: the same gather read directly from device memory;

both gathers with lane-varying and lane-uniform (row permutation) indices.
Then the library's row gather (``torch.index_select``, the counterpart of
the JAX probe's ``jnp.take`` outside any kernel) at the JAX probe's five
(rows, width) cases, from 2^20 source rows.

Kernel ``gather_tile_kernel<Mode>`` (``csrc/probes.cu``) replaces
``make_gather``'s kernels (``tools/probe_gather.py:40``).  Wrapper
``gather_tile`` (counted in ``gather_tile.launches``; it also launches
``ONESHOT``, the first design of ``gather_smem``: one CTA per strip, staged
whole, then gathered, kept as its reference and no case of the probe),
plain version
``gather_tile_plain`` (``torch.take_along_dim`` on the [nb, S, 128] view;
the elementwise modes in separately rounded torch ops, as the kernel
rounds them under ``--fmad=false``).
"""

from __future__ import annotations

import argparse
import collections
import itertools
import sys

import numpy as np
import torch

from ..ops.launch import check, raise_on, stream, use_plain
from . import bound, card, kernels, resolve_device, time_ms

LANES = 128
# in the order of csrc/probes.cu's GatherMode
MODES = ("ew", "chain", "gather_smem", "gather_global")
ONESHOT = "gather_smem_oneshot"  # gather_smem's first design, its reference
KERNEL_MODES = (*MODES, ONESHOT)
SIZES = (128, 256, 512, 1024, 1920)
ELEMENTS = 1 << 22
SMEM_MAX = 232_448   # shared memory one block may use (227 KB)
SMEM_RESERVED = 256  # gather_smem's ring: its alignment slack and barriers
MAX_STAGES, MAX_BOX_ROWS = 3, 256  # the ring's buffers; TMA's box side
ROW_SOURCE = 1 << 20
ROW_CASES = ((1 << 22, 8), (1 << 22, 32), (1 << 22, 128), (1 << 20, 8),
             (1 << 23, 8))
CHAIN_STEPS, CHAIN_MUL, CHAIN_ADD = 12, float(np.float32(1.0001)), 0.5


def strip_width(S: int) -> int:
    """``gather_smem``'s strip width: the widest power of two w <= 32
    whose strip [S, w] f32 fits twice in one block's shared memory (w >= 8:
    a TMA box row is at least 16 B and a consumer reads 4 lanes)."""
    w = 32
    while 2 * S * w * 4 + SMEM_RESERVED > SMEM_MAX:
        w //= 2
        if w < 8:
            raise ValueError(f"two [{S}, 8] f32 strips exceed {SMEM_MAX} B")
    return w


def oneshot_width(S: int) -> int:
    """``ONESHOT``'s strip width: the widest power of two w <= 32 whose one
    strip fits in one block's shared memory."""
    w = 32
    while S * w * 4 > SMEM_MAX:
        w //= 2
        if w == 0:
            raise ValueError(f"a [{S}, 1] f32 strip exceeds {SMEM_MAX} bytes")
    return w


def pipeline(S: int) -> dict:
    """``gather_smem``'s ring at window height S: the strip width ``w``,
    ``stages`` (as many strips as fit, at most 3) and ``box_rows`` (the
    TMA box's rows: S split into the fewest equal boxes of at most 256
    rows whose byte size is a multiple of 128, each box's shared-memory
    offset being aligned so)."""
    w = strip_width(S)
    stages = min(MAX_STAGES, (SMEM_MAX - SMEM_RESERVED) // (S * w * 4))
    for boxes in range(-(-S // MAX_BOX_ROWS), S + 1):
        rows = S // boxes
        if S % boxes == 0 and rows * w * 4 % 128 == 0:
            return dict(w=w, stages=stages, box_rows=rows)
    raise ValueError(f"no TMA box of at most {MAX_BOX_ROWS} rows splits "
                     f"S = {S} at w = {w}")


def bank_reckoning(S: int, elements: int, sms: int, clock_hz: float
                   ) -> dict:
    """The lane-varying reads' bank conflicts at S: a warp's 32 reads of one
    step hit at most ``ways`` = 32 / w reads per bank (each thread starts
    at its row in the warp, mod 4), so over the run at most ``ways`` cycles
    per warp read, ``cycles_per_sm`` in all on each SM, ``us`` at the
    clock (all under the device-memory time when it overlaps)."""
    ways = 32 // strip_width(S)
    cycles = -(-elements // 32 // sms) * ways
    return dict(ways=ways, cycles_per_sm=cycles, us=cycles / clock_hz * 1e6)


def gather_tile_plain(src: torch.Tensor, idx: torch.Tensor, S: int,
                      mode: str) -> torch.Tensor:
    """Mode ``mode`` over the blocks [S, 128] of ``src``; the gathers take
    ``idx`` (rows of the same block, in [0, S))."""
    if mode == "ew":
        return src * 2.0 + 1.0
    if mode == "chain":
        x = src
        for _ in range(CHAIN_STEPS):
            x = x * CHAIN_MUL + CHAIN_ADD
        return x
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown gather mode {mode!r}; one of "
                         f"{KERNEL_MODES}")
    nb = src.shape[0] // S
    return torch.take_along_dim(src.view(nb, S, LANES),
                                idx.view(nb, S, LANES).long(),
                                dim=1).view(-1, LANES)


def gather_tile(src: torch.Tensor, idx: torch.Tensor, S: int, mode: str,
                grid: int = 0) -> torch.Tensor:
    """``gather_tile_kernel<mode>`` over ``src`` [nb * S, 128] f32 with
    ``idx`` [nb * S, 128] int32 (read by the gather modes only; an index
    outside [0, S) traps on the card, a device-side launch failure); the
    plain version on CPU tensors.  ``mode`` is one of ``MODES`` or
    ``ONESHOT``.  ``grid`` > 0 caps ``gather_smem``'s persistent CTAs
    (0: as many as fit on the SMs), so that each walks many tiles."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"unknown gather mode {mode!r}; one of "
                         f"{KERNEL_MODES}")
    if grid < 0:
        raise ValueError(f"grid is a count of CTAs (0: all that fit), "
                         f"got {grid}")
    if use_plain(src):
        return gather_tile_plain(src, idx, S, mode)
    rows = src.shape[0]
    if S <= 0 or rows % S or src.numel() >= 2**31:
        raise ValueError(f"need [nb * S, 128] with S = {S} dividing the rows "
                         f"and fewer than 2^31 elements, got {tuple(src.shape)}")
    check(src.device, src=(src, torch.float32, (rows, LANES)),
          idx=(idx, torch.int32, (rows, LANES)))
    out = torch.empty_like(src)
    ring = (pipeline(S) if mode == "gather_smem"
            else dict(w=oneshot_width(S) if mode == ONESHOT else 0,
                      stages=0, box_rows=0))
    lib = kernels()
    err = lib.probe_gather_tile(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), S, rows // S,
        ring["w"], ring["stages"], ring["box_rows"], grid,
        KERNEL_MODES.index(mode), stream(src.device))
    raise_on(lib, err, f"gather_tile_kernel<{mode}>")
    gather_tile.launches += 1
    return out


WRAPPERS = (gather_tile,)
gather_tile.launches = 0

# the timed runs' copies of their inputs: a gather at the probe's size
# moves 3 x 16.8 MB, so 4 copies span ~4x the card's 50 MB L2
COPIES = 4


def rotation(fn, *tensors, copies: int = COPIES):
    """A callable for the timer: each call runs ``fn`` on the next of
    ``copies`` copies of ``tensors`` (the tensors themselves first) and
    holds the last ``copies`` outputs, so a launch reads and writes memory
    that the ``copies - 1`` launches before it did not touch: at the
    probe's sizes the data comes from device memory, not from L2, as the
    bytes bound counts it."""
    sets = [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    held = collections.deque(maxlen=copies)
    return lambda: held.append(fn(*next(turn)))


def make_inputs(S: int, elements: int, device, seed: int = 0):
    """(src, lane-varying idx, lane-uniform idx) for nb = elements // (S *
    128) blocks (at least one) of [S, 128]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = max(1, elements // (S * LANES)) * S
    src = torch.randn(rows, LANES, generator=gen, device=device)
    idx_v = torch.randint(0, S, (rows, LANES), generator=gen, device=device,
                          dtype=torch.int32)
    idx_u = torch.randint(0, S, (rows, 1), generator=gen, device=device,
                          dtype=torch.int32).expand(rows, LANES).contiguous()
    return src, idx_v, idx_u


# (label, mode, lane-uniform indices) of each timed column
CASES = (("ew", "ew", False), ("chain", "chain", False),
         ("gather_smem", "gather_smem", False),
         ("gather_smem_uniform", "gather_smem", True),
         ("gather_global", "gather_global", False),
         ("gather_global_uniform", "gather_global", True))


def main(device="cuda") -> dict:
    """One dict line per S (ms of every case), one per row-gather case, and
    the finding.  On the CPU (plain versions): 2^14 elements and 2^12
    source rows (row counts cut by the same factor), host times, no
    bounds."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    elements = ELEMENTS if on_card else 1 << 14
    row_source = ROW_SOURCE if on_card else 1 << 12
    print("== in-kernel gather probe on "
          + (card(dev.index or 0)["name"] if on_card
             else "cpu (plain versions, host times)") + " ==")
    tiles = []
    for S in SIZES:
        src, idx_v, idx_u = make_inputs(S, elements, dev)
        w = strip_width(S)
        row = {"S": S, "nb": src.shape[0] // S, "w": w,
               "stages": pipeline(S)["stages"]}
        row["bank_conflicts"] = "none" if w == 32 else f"<= {32 // w}-way"
        if on_card and w < 32:
            c = card(dev.index or 0)
            bank = bank_reckoning(S, src.numel(), c["sms"], c["clock_hz"])
            row["bank_conflicts"] += (
                f": <= {bank['cycles_per_sm']} shared-memory cycles per SM, "
                f"{bank['us']:.2f} us")
        for label, mode, uniform in CASES:
            row[label] = time_ms(rotation(
                lambda s, i: gather_tile(s, i, S, mode), src,
                idx_u if uniform else idx_v), dev)
        row["smem_over_ew"] = row["gather_smem"] / row["ew"]
        row["global_over_ew"] = row["gather_global"] / row["ew"]
        if on_card:  # a gather reads src and idx once and writes out once
            row["gather_bound_ms"] = bound(3 * src.nbytes, 0.0)[0]
        print({k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in row.items()}, flush=True)
        tiles.append(row)
    print("== row gather (torch.index_select) ==")
    gen = torch.Generator(device=dev).manual_seed(0)
    row_gather = []
    for rows, width in ROW_CASES:
        rows = rows * row_source // ROW_SOURCE
        src = torch.randn(row_source, width, generator=gen, device=dev)
        idx = torch.randint(0, row_source, (rows,), generator=gen,
                            device=dev, dtype=torch.int32)
        ms = time_ms(lambda: torch.index_select(src, 0, idx), dev, iters=10)
        r = {"rows": rows, "width": width, "ms": round(ms, 4),
             "Mrows_per_ms": round(rows / ms / 1e6, 3),
             "GBps": round(rows * width * 4 / ms / 1e6, 1)}
        print(r, flush=True)
        row_gather.append(r)
    print("finding: shared-memory gather / ew per element at S = "
          + ", ".join(f"{r['S']}: {r['smem_over_ew']:.2f}" for r in tiles)
          + "; lane-uniform "
          + ", ".join(f"{r['gather_smem_uniform'] / r['ew']:.2f}"
                      for r in tiles)
          + "; direct global gather / ew "
          + ", ".join(f"{r['global_over_ew']:.2f}" for r in tiles))
    return dict(tiles=tiles, row_gather=row_gather, device=str(dev))


def cli(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
