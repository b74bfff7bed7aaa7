"""The pair distance as a small matrix product on the card: counterpart of
``tools/probe_mxu.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_mxu \\
        [--device cpu]

The TPU probe checked, in one kernel, the three steps a transposed
matrix-unit sweep needs: transpose three [9, 128] granules into a [384, 9]
scratch, slice it dynamically at ``off`` ([160, 9]), and compute
d^2 = P Q with P = [x_j, |x_j|^2, 1] [160, 5] and Q = [-2 x_i; 1; |x_i|^2]
[5, 128] at HIGHEST precision.  Here the question is whether the pair
distance, and so the force sums, can run on the tensor cores, and at what
precision: ``d2_tile_kernel`` computes the same tile in three modes, ``fma``
(f32 on the CUDA cores), ``tf32`` (one ``mma.sync`` m16n8k8 product) and
``tf32x3`` (big and small TF32 parts, three products: the analog of
HIGHEST).  The probe prints

1. at the JAX probe's own shapes (one tile, off = 40): each mode's max abs
   error against its plain version and against the f32 plain version (bar
   1e-4, as the JAX probe; TF32 against f32 is the finding, not a bar);
2. over 4096 tiles (each with its own off in [0, 224]), at N(0, 1)
   positions and at the same positions shifted by 12.8 in every coordinate
   (the 1M splash's box, 128^3 cells of h = 0.1): each mode's, and the
   direct f32 form's (sum of squared differences, as K1/K2 compute d^2),
   max abs error against the exact d^2 and the number of pair decisions
   d^2 < h^2 it flips;
3. each mode's time over the tiles (queued CUDA events, 3 warmup + 20
   timed runs) beside its bound, and ``torch.bmm`` of the same P and Q in
   f32;

and the finding.

Kernel ``d2_tile_kernel<Mode>`` (``csrc/probes.cu``) replaces ``kernel``
(``tools/probe_mxu.py:27``).  Wrapper ``d2_tile`` (counted in
``d2_tile.launches``), plain version ``d2_tile_plain``: transpose, slice
and ``torch.matmul`` with TF32 off; for ``tf32`` the operands are first
rounded to TF32 (``tf32_round``), for ``tf32x3`` split as the kernel
splits them, so the products are exact in f32 and only the order of the
sums differs from the kernel's.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from ..ops.launch import check, raise_on, stream, use_plain
from . import (F32_FLOPS, TF32_FLOPS, bound, card, kernels, max_abs,
               resolve_device, time_ms)

F = 9             # rows of a granule
GRANULES = 3
LANES = 128
TR_ROWS = GRANULES * LANES  # 384
ST = 160          # window rows
OFF_MAX = TR_ROWS - ST      # 224
# in the order of csrc/probes.cu's D2Mode
MODES = ("fma", "tf32", "tf32x3")
BAR = 1e-4        # max abs, the JAX probe's bar
TILES = 4096
SHIFT = 12.8      # the 1M splash's box edge (models/scenes.py:85)
H = 0.1           # its smoothing length
H2 = float(np.float32(H * H))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 explicit mantissa bits, kept in an f32) as
    ``cvt.rna.tf32.f32``: to nearest, ties away from zero.  Adding half of
    the 13 dropped bits' range to the bit pattern rounds the magnitude
    (a carry reaches the exponent); inf and NaN pass through."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes f32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


@contextlib.contextmanager
def _f32_matmul():
    """torch's CUDA matmul in full f32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _window(g: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Rows [off, off + 160) of each tile's transposed granules: [T, 160, 9]."""
    T = g.shape[0]
    tr = g.transpose(2, 3).reshape(T, TR_ROWS, F)
    rows = off.long()[:, None] + torch.arange(ST, device=g.device)
    return torch.gather(tr, 1, rows[:, :, None].expand(T, ST, F))


def operands(g: torch.Tensor, selfv: torch.Tensor, off: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """P [T, 160, 5] and Q [T, 5, 128], the squared norms summed left to
    right as the kernel sums them."""
    w = _window(g, off)
    x0, x1, x2 = w[..., 0], w[..., 1], w[..., 2]
    p = torch.stack([x0, x1, x2, x0 * x0 + x1 * x1 + x2 * x2,
                     torch.ones_like(x0)], -1)
    y0, y1, y2 = selfv[:, 0], selfv[:, 1], selfv[:, 2]
    q = torch.stack([-2.0 * y0, -2.0 * y1, -2.0 * y2, torch.ones_like(y0),
                     y0 * y0 + y1 * y1 + y2 * y2], 1)
    return p, q


def d2_tile_plain(g: torch.Tensor, selfv: torch.Tensor, off: torch.Tensor,
                  mode: str = "fma") -> torch.Tensor:
    """d^2 [T, 160, 128] of each tile, in mode ``mode``'s arithmetic."""
    if mode not in MODES:
        raise ValueError(f"unknown d2 mode {mode!r}; one of {MODES}")
    p, q = operands(g, selfv, off)
    with _f32_matmul():
        if mode == "fma":
            return torch.matmul(p, q)
        pb, qb = tf32_round(p), tf32_round(q)
        if mode == "tf32":
            return torch.matmul(pb, qb)
        ps, qs = tf32_round(p - pb), tf32_round(q - qb)
        return (torch.matmul(ps, qb) + torch.matmul(pb, qs)
                + torch.matmul(pb, qb))


def d2_tile(g: torch.Tensor, selfv: torch.Tensor, off: torch.Tensor,
            mode: str) -> torch.Tensor:
    """``d2_tile_kernel<mode>``: g [T, 3, 9, 128] f32 (granules), selfv
    [T, 9, 128] f32 (rows 0-2: the self positions), off [T] int32 in
    [0, 224] (an off outside traps on the card, a device-side launch
    failure); returns d^2 [T, 160, 128].  The plain version on CPU
    tensors."""
    if mode not in MODES:
        raise ValueError(f"unknown d2 mode {mode!r}; one of {MODES}")
    if use_plain(g):
        return d2_tile_plain(g, selfv, off, mode)
    T = g.shape[0]
    check(g.device, g=(g, torch.float32, (T, GRANULES, F, LANES)),
          selfv=(selfv, torch.float32, (T, F, LANES)),
          off=(off, torch.int32, (T,)))
    out = torch.empty(T, ST, LANES, dtype=torch.float32, device=g.device)
    lib = kernels()
    err = lib.probe_d2_tile(g.data_ptr(), selfv.data_ptr(), off.data_ptr(),
                            out.data_ptr(), T, MODES.index(mode),
                            stream(g.device))
    raise_on(lib, err, f"d2_tile_kernel<{mode}>")
    d2_tile.launches += 1
    return out


WRAPPERS = (d2_tile,)
d2_tile.launches = 0


def direct_d2(g: torch.Tensor, selfv: torch.Tensor, off: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """d^2 as the sweeps form it: the squared coordinate differences,
    summed left to right, in ``dtype`` (f64: the exact value)."""
    xj = _window(g, off)[..., :3].to(dtype)        # [T, 160, 3]
    xi = selfv[:, :3].to(dtype)                    # [T, 3, 128]
    d = [xj[..., c, None] - xi[:, c, None, :] for c in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def make_tiles(tiles: int, device, off: int | None = None, seed: int = 0):
    """N(0, 1) granules and self rows; each tile's off uniform in [0, 224],
    or ``off`` for every tile."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(tiles, GRANULES, F, LANES, generator=gen, device=device)
    selfv = torch.randn(tiles, F, LANES, generator=gen, device=device)
    if off is None:
        offs = torch.randint(0, OFF_MAX + 1, (tiles,), generator=gen,
                             device=device, dtype=torch.int32)
    else:
        offs = torch.full((tiles,), off, dtype=torch.int32, device=device)
    return g, selfv, offs


def timed_bound(g, selfv, off, mode: str) -> tuple[float, str]:
    """A mode's bound over the given tiles: the bytes d^2 needs, read once
    (each tile's off, the three position rows of its 160 window rows and
    of its 128 self lanes; the other granule rows are never used) and d^2
    written once, against its products' flops (K padded to 8 on the tensor
    cores)."""
    T = g.shape[0]
    nbytes = off.nbytes + 4 * T * (3 * ST + 3 * LANES + ST * LANES)
    elems = T * ST * LANES
    ops_ms = {"fma": elems * 10 / F32_FLOPS,
              "tf32": elems * 16 / TF32_FLOPS,
              "tf32x3": 3 * elems * 16 / TF32_FLOPS}[mode] * 1e3
    return bound(nbytes, ops_ms)


def main(device="cuda") -> dict:
    """The three parts above, printed; returns their numbers and ``ok``
    (every mode within the JAX probe's bar).  On the CPU (plain versions):
    16 tiles, host times, no bounds."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    tiles = TILES if on_card else 16
    print("== d^2 tile probe on "
          + (card(dev.index or 0)["name"] if on_card
             else "cpu (plain versions, host times)") + " ==")
    g, selfv, off = make_tiles(1, dev, off=40)
    want = d2_tile_plain(g, selfv, off, "fma")
    ok, first = True, {}
    for mode in MODES:
        got = d2_tile(g, selfv, off, mode)
        own = max_abs(got, d2_tile_plain(g, selfv, off, mode))
        f32 = max_abs(got, want)
        passed = own <= BAR and (mode == "tf32" or f32 <= BAR)
        ok &= passed
        first[mode] = dict(vs_plain=own, vs_f32=f32)
        print(f"mode={mode:6s} T=1 off=40  max_abs_err vs its plain "
              f"{own:.3e}  vs f32 {f32:.3e}  {'OK' if passed else 'FAIL'}")

    g, selfv, off = make_tiles(tiles, dev)
    mask = {}
    for shift in (0.0, SHIFT):
        gs, ss = g + shift, selfv + shift
        true = direct_d2(gs, ss, off, torch.float64)
        inside = true < H2
        forms = {m: d2_tile(gs, ss, off, m) for m in MODES}
        forms["direct_f32"] = direct_d2(gs, ss, off, torch.float32)
        for name, d2 in forms.items():
            err = max_abs(d2, true)
            flips = int(((d2 < H2) != inside).sum())
            mask[(shift, name)] = dict(err=err, flips=flips,
                                       within=int(inside.sum()))
            print(f"shift={shift:4.1f} {name:10s} max_abs_err vs exact d^2 "
                  f"{err:.3e} ({err / H2:.2%} of h^2)  d^2 < h^2 decided "
                  f"wrongly for {flips} pairs ({int(inside.sum())} of "
                  f"{inside.numel()} pairs within h={H}, {tiles} tiles)")
        del forms, true, inside

    timed = {}
    for mode in MODES:
        ms = time_ms(lambda: d2_tile(g, selfv, off, mode), dev)
        timed[mode] = dict(ms=ms)
        line = f"mode={mode:6s} T={tiles} {ms:.4f} ms"
        if on_card:
            b, by = timed_bound(g, selfv, off, mode)
            timed[mode].update(bound_ms=b, bound_by=by)
            line += f"  bound {b * 1e3:.1f} us ({by})  {ms / b:.2f}x bound"
        print(line)
    p, q = operands(g, selfv, off)
    with _f32_matmul():
        library_ms = time_ms(lambda: torch.bmm(p, q), dev)
    print(f"torch.bmm f32 of the same P [{tiles}, 160, 5], Q [{tiles}, 5, "
          f"128]: {library_ms:.4f} ms")
    e0, e1 = mask[(0.0, "tf32")], mask[(SHIFT, "tf32")]
    x3, fm, dr = (mask[(SHIFT, m)] for m in ("tf32x3", "fma", "direct_f32"))
    print(f"finding: TF32 d^2 against f32 at N(0,1) {first['tf32']['vs_f32']:.2e}"
          f" (one tile); against the exact d^2 over {tiles} tiles "
          f"{e0['err']:.2e} ({e0['err'] / H2:.1%} of h^2; {e0['flips']} "
          f"wrong mask decisions, {e0['within']} pairs within h), shifted by "
          f"{SHIFT} {e1['err']:.2e} ({e1['err'] / H2:.0%} of h^2; "
          f"{e1['flips']} wrong, {e1['within']} within h); shifted, 3xTF32 "
          f"{x3['err']:.2e} ({x3['flips']} wrong), f32 FMA {fm['err']:.2e} "
          f"({fm['flips']}), direct f32 {dr['err']:.2e} ({dr['flips']}); "
          f"3xTF32 costs {timed['tf32x3']['ms'] / timed['fma']['ms']:.2f}x "
          f"FMA, TF32 {timed['tf32']['ms'] / timed['fma']['ms']:.2f}x")
    return dict(ok=ok, first=first, mask=mask, timed=timed,
                library_ms=library_ms, tiles=tiles, device=str(dev))


def cli(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return 0 if main(ap.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(cli())
