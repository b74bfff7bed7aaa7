"""Times of the primitive ops the step is built from: counterpart of
``tools/microbench.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.microbench \\
        [--device cpu]

The JAX tool's ops at its shapes, in PyTorch: row gathers of 12.6M indices
(32k particles x 384 candidates) from [32k, 3], [32k] and [32k, 8] sources
(advanced indexing), ``take_along_dim`` of a [32k, 384] index over [32k],
an elementwise multiply-add over 12.6M, a stable ``argsort`` and a
``searchsorted`` of 32k queries at 32k and 1M, and the 32k x 4 x 96
contiguous slice gather (``unfold`` windows indexed by their starts; the
JAX tool's ``vmap`` of ``dynamic_slice``).  The one-hot matrix-product
gather stays commented out, as in the JAX tool.  Each op is one launch,
timed by queued CUDA events (``tools.time_ms``: 3 warmup + 20 runs).
``ops`` builds the inputs from a seed and returns, per op, the call and its
numpy equivalent; ``tests/test_torch_tools_ab.py`` holds each against the
other at small sizes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import host_tag, start, time_ms

N = 32768
K_TOTAL = 12_582_912      # 32k particles x 384 candidates
CANDS = 384
SORT_SIZES = (32768, 1_000_000)
SLICE_ROWS, SLICE_RODS, SLICE_LEN = 32768, 4, 96


def ops(dev, n: int = N, k_total: int = K_TOTAL, cands: int = CANDS,
        sort_sizes=SORT_SIZES, slice_rows: int = SLICE_ROWS,
        seed: int = 0) -> list[tuple[str, object, object]]:
    """[(label, call, numpy equivalent)] on inputs drawn from ``seed``; each
    call and its equivalent take no argument."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    put = lambda t: t.to(dev)
    src3 = put(torch.randn(n, 3, generator=g))
    src1 = put(torch.randn(n, generator=g))
    src8 = put(torch.randn(n, 8, generator=g))
    idx = put(torch.randint(0, n, (k_total,), generator=g, dtype=torch.int32))
    idx2d = idx.reshape(-1, cands)
    big = put(torch.randn(k_total, generator=g))
    h = lambda t: t.cpu().numpy()
    out = [
        (f"gather [{k_total}] rows from [{n},3]", lambda: src3[idx],
         lambda: h(src3)[h(idx)]),
        (f"gather [{k_total}] from [{n}] 1D", lambda: src1[idx],
         lambda: h(src1)[h(idx)]),
        (f"gather [{k_total}] rows from [{n},8]", lambda: src8[idx],
         lambda: h(src8)[h(idx)]),
        (f"take_along_dim 2d [{k_total // cands},{cands}] of [{n}]",
         lambda: torch.take_along_dim(src1[:, None], (idx2d % n).long(), 0),
         lambda: np.take_along_axis(h(src1)[:, None], h(idx2d) % n, 0)),
        # the one-hot matrix-product gather (MXU) of the JAX tool stays out
        # there too
        (f"elementwise mul+add on [{k_total}]", lambda: big * 1.5 + 2.0,
         lambda: h(big) * np.float32(1.5) + np.float32(2.0)),
    ]
    for m in sort_sizes:
        cid = put(torch.randint(0, n, (m,), generator=g, dtype=torch.int32))
        sorted_cid = torch.sort(cid).values
        q = torch.arange(n, dtype=torch.int32, device=dev)
        out += [
            (f"argsort [{m}] int32",
             lambda c=cid: torch.argsort(c, stable=True),
             lambda c=cid: np.argsort(h(c), kind="stable")),
            (f"searchsorted {n} queries in [{m}]",
             lambda a=sorted_cid: torch.searchsorted(a, q),
             lambda a=sorted_cid: np.searchsorted(h(a), h(q))),
        ]
    starts = put(torch.randint(0, n - SLICE_LEN, (slice_rows, SLICE_RODS),
                               generator=g, dtype=torch.int32))
    out.append((
        f"unfold slice gather {slice_rows} x {SLICE_RODS} x {SLICE_LEN} "
        f"from [{n}]",
        lambda: src1.unfold(0, SLICE_LEN, 1)[starts.long()],
        lambda: h(src1)[h(starts)[..., None] + np.arange(SLICE_LEN)]))
    return out


def main(device="cuda", **sizes) -> dict:
    dev = start(device)
    host = host_tag(dev)
    times = {}
    for label, call, _ in ops(dev, **sizes):
        times[label] = time_ms(call, dev)
        print(f"{label:44s} {times[label]:9.3f} ms{host}", flush=True)
    return times


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m smoothed_particle_hydrodynamics_tpu_torch.tools."
             "microbench")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
