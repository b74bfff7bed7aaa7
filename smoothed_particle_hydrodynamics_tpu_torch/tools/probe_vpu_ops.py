"""Per-op cost of the force loops' f32 arithmetic on the card: counterpart of
``tools/probe_vpu_ops.py``.

    python -m smoothed_particle_hydrodynamics_tpu_torch.tools.probe_vpu_ops \\
        [--device cpu]

The force kernels (``csrc/sweep_t.cu`` K2 and K3, ``csrc/sweep_lane.cu``)
spend one IEEE ``sqrtf`` and one IEEE divide per pair within h.  If those
issue as multi-instruction sequences while ``rsqrtf`` and the approximate
reciprocal issue as one instruction, rewriting the center term as a
reciprocal-multiply chain is a kernel gain.  This probe times K-deep chains
of each op over the same [512 * 256, 128] f32 array (one thread per element,
the chain in registers), plus the three forms of the force kernel's center
term, and prints per op: ms (CUDA events, 3 warmup + 20 timed runs), G op/s,
the cost relative to mul, and the op's bound (the larger of the bytes over
the HBM rate and its instructions over the card's issue rate for their
class, at the SM count and maximum SM clock the run reads).  The mul chain
sits near the memory bound, so each op's cost is also given against its own
issue bound.  Then the approximate reciprocal's relative error over d in
[1e-3, 4] (K = 1), the instruction mix of each chain in the built SASS
(``cuobjdump``: ``sqrtf`` and ``/`` must stay IEEE sequences, and every
chain must issue its MUFU instructions, not fold), and the findings.

Kernel ``chain_kernel<Op>`` (``csrc/probes.cu``) replaces ``_chain_kernel``
(``tools/probe_vpu_ops.py:36``) and the reciprocal table kernel (``:118``).
Wrapper ``chain`` (counted in ``chain.launches``), plain version
``chain_plain``: the same chain in torch ops with f32 constants, every op
rounded to f32 as the kernel rounds it (``sqrt`` through f64: torch's f32
``sqrt`` on the CPU is not correctly rounded); where the kernel
approximates (``rsqrtf``, ``rcp.approx``), the plain version computes the
exact value.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..ops.launch import check, raise_on, stream, use_plain
from ..utils import build
from . import (FP32_PER_CLK, MUFU_PER_CLK, bound, card, issue_ms, kernels,
               resolve_device, time_ms)

ROWS = 256     # rows per block of the JAX probe
BLOCKS = 512   # its grid
K = 64         # chain depth
# in the order of csrc/probes.cu's ChainOp
OPS = ("mul", "add", "sqrt", "rsqrt", "div", "recip", "recip_approx",
       "select", "center_now", "center_recip", "center_rsqrt")
LABELS = dict(mul="mul", add="add", sqrt="sqrt", rsqrt="rsqrt",
              div="div (1/x chain)", recip="recip exact",
              recip_approx="recip approx", select="select",
              center_now="center: sqrt+div (now)",
              center_recip="center: sqrt+recip~",
              center_rsqrt="center: rsqrt+recip~")
# kernel against plain: 0.0 = bit-equal (both round every op in IEEE f32,
# no FMA), else the largest relative error (the kernel approximates)
BARS = dict(mul=0.0, add=0.0, sqrt=0.0, rsqrt=1e-5, div=0.0, recip=0.0,
            recip_approx=1e-5, select=0.0, center_now=0.0,
            center_recip=1e-5, center_rsqrt=1e-5)
# the least instructions one step issues: (f32 add/mul, MUFU); IEEE sqrtf,
# divide and __frcp_rn count their one MUFU op, not their refinement; the
# approximate reciprocal's step adds the opaque zero (csrc/probes.cu)
MIX = dict(mul=(1, 0), add=(1, 0), sqrt=(0, 1), rsqrt=(0, 1), div=(0, 1),
           recip=(0, 1), recip_approx=(1, 1), select=(1, 0),
           center_now=(9, 2), center_recip=(10, 2), center_rsqrt=(11, 2))
# the MUFU instructions one step of each op issues in the built SASS; a
# chain the compiler did not fold issues at least 16 of each (one unrolled
# body) beyond the mul chain's, which has only its loop's integer division
MUFU_SASS = dict(sqrt=("MUFU.RSQ",), rsqrt=("MUFU.RSQ",), div=("MUFU.RCP",),
                 recip=("MUFU.RCP",), recip_approx=("MUFU.RCP",),
                 center_now=("MUFU.RSQ", "MUFU.RCP"),
                 center_recip=("MUFU.RSQ", "MUFU.RCP"),
                 center_rsqrt=("MUFU.RSQ", "MUFU.RCP"))
UNROLL = 16  # csrc/probes.cu: #pragma unroll 16
# f32 ops K2 (csrc/sweep_t.cu force_kernel_t) spends on a pair within h,
# the sqrtf and the divide among them
K2_FLOPS_PER_PAIR = 36


def _c(v: float) -> float:
    """``v`` rounded to f32, as a Python float (the kernel's f32 literal)."""
    return float(np.float32(v))


# the center term's constants (tools/probe_vpu_ops.py:90)
_H, _EPS, _SCALE, _M = 2.0, _c(1e-3), _c(0.77), _c(1.1)


def _sqrt(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v.double()).float()


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    return torch.rsqrt(v.double()).float()


def _center(s: torch.Tensor, d: torch.Tensor, inv) -> torch.Tensor:
    hd = _H - d
    if inv is None:  # a true divide, as K2
        return (hd * hd) * _M / (d + _EPS) * _SCALE * _c(0.3) + s * _c(0.7)
    return (hd * hd) * _M * inv(d + _EPS) * _SCALE * _c(0.3) + s * _c(0.7)


_PLAIN = dict(
    mul=lambda v: v * _c(1.0000001),
    add=lambda v: v + _c(1e-7),
    sqrt=_sqrt,
    rsqrt=_rsqrt,
    # a 0-d tensor divided by v: `c / v` would multiply by 1/v instead
    div=lambda v: torch.tensor(_c(1.0000001), device=v.device) / v,
    recip=torch.reciprocal,
    recip_approx=torch.reciprocal,
    select=lambda v: torch.where(v > 1.0, v * _c(0.9999), v),
    center_now=lambda s: _center(s, _sqrt(s) * _SCALE, None),
    center_recip=lambda s: _center(s, _sqrt(s) * _SCALE, torch.reciprocal),
    center_rsqrt=lambda s: _center(s, s * _rsqrt(s) * _SCALE,
                                   torch.reciprocal),
)


def chain_plain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """``k`` steps of op ``op`` on every element of ``x`` (f32)."""
    fn = _PLAIN[op]
    for _ in range(k):
        x = fn(x)
    return x


def chain(x: torch.Tensor, op: str, k: int) -> torch.Tensor:
    """``chain_kernel<op>``: ``k`` steps of ``op`` on every element of the
    contiguous f32 tensor ``x``; the plain version on a CPU tensor."""
    if op not in OPS:
        raise ValueError(f"unknown chain op {op!r}; one of {OPS}")
    if use_plain(x):
        return chain_plain(x, op, k)
    check(x.device, x=(x, torch.float32, tuple(x.shape)))
    out = torch.empty_like(x)
    lib = kernels()
    err = lib.probe_chain(x.data_ptr(), out.data_ptr(), x.numel(),
                          OPS.index(op), k, stream(x.device))
    raise_on(lib, err, f"chain_kernel<{op}>")
    chain.launches += 1
    return out


WRAPPERS = (chain,)
chain.launches = 0


def make_input(blocks: int, device, seed: int = 0) -> torch.Tensor:
    """The JAX probe's input: 1.3 + U[0, 1) * 0.5, [blocks * 256, 128] f32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(blocks * ROWS, 128, generator=gen, device=device)
    return 1.3 + u * 0.5


def recip_table(device) -> torch.Tensor:
    """The reciprocal-accuracy table's d: 8192 values in [1e-3, 4], + 1e-3."""
    return torch.linspace(1e-3, 4.0, 8192, device=device) + 1e-3


def recip_rel_err(d: torch.Tensor, approx: torch.Tensor) -> tuple[float,
                                                                   float]:
    """(max, mean) of |approx - 1/d| * d, in f64."""
    dd = d.double()
    rel = (approx.double() - 1.0 / dd).abs() * dd
    return rel.max().item(), rel.mean().item()


def sass_mix() -> dict:
    """Per chain op, its kernel's f32, MUFU and control instructions in the
    built library's SASS (``cuobjdump -sass``); empty when the toolkit has
    no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return {}
    kernels()  # built
    out = subprocess.run([tool, "-sass", str(build.library_path("probes"))],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    mix, op = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            m = re.search(r"chain_kernelILi(\d+)E", line)
            op = OPS[int(m.group(1))] if m else None
            if op:
                mix[op] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if op and m and m.group(1).startswith(("MUFU", "F", "CALL", "BRA")):
            mix[op][m.group(1)] += 1
    return mix


def sass_folded(mix: dict) -> list[str]:
    """The chain ops whose kernel issues fewer than one unrolled body of
    its MUFU instructions (the compiler folded the chain)."""
    base = mix["mul"]
    return [f"{op}: {ins} {mix[op][ins]} (mul chain {base[ins]})"
            for op, names in MUFU_SASS.items() for ins in names
            if mix[op][ins] - base[ins] < UNROLL]


def main(device="cuda") -> dict:
    """Time every chain op and print one line per op, the reciprocal's
    error, the SASS mix and the findings.  On the CPU (plain versions):
    one block and K = 4 (the JAX probe's interpret sizes), host times, no
    bounds."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    k = K if on_card else 4
    x = make_input(BLOCKS if on_card else 1, dev)
    n = x.numel()
    print(f"== chain probe: {n} f32 elements, K = {k}, on "
          + (card(dev.index or 0)["name"] if on_card
             else "cpu (plain versions, host times)") + " ==")
    rows, base = {}, None
    for op in OPS:
        ms = time_ms(lambda: chain(x, op, k), dev)
        row = dict(ms=ms, gops=n * k / ms / 1e6)
        line = f"{LABELS[op]:28s} {ms:8.3f} ms  {row['gops']:7.1f} Gop/s"
        if base is not None:
            row["x_mul"] = ms / base
            line += f"  {row['x_mul']:5.2f}x mul"
        if on_card:
            fp32, mufu = MIX[op]
            ops_ms = max(issue_ms(n * k * fp32, FP32_PER_CLK),
                         issue_ms(n * k * mufu, MUFU_PER_CLK))
            row["bound_ms"], row["bound_by"] = bound(2 * x.nbytes, ops_ms)
            row["issue_ms"] = ops_ms
            line += (f"  bound {row['bound_ms'] * 1e3:7.1f} us "
                     f"({row['bound_by']})  {ms / row['bound_ms']:5.2f}x bound"
                     f"  {ms / ops_ms:5.2f}x its issue bound")
        print(line)
        rows[op] = row
        base = ms if base is None else base
    d = recip_table(dev)
    err = recip_rel_err(d, chain(d, "recip_approx", 1))
    print(f"recip approx rel err: max {err[0]:.3e} mean {err[1]:.3e}")
    result = dict(ops=rows, recip_err=err, n=n, k=k, device=str(dev))
    if not on_card:
        return result
    result["sass"] = mix = sass_mix()
    for op, counts in mix.items():
        print(f"sass chain_kernel<{op}>: "
              + " ".join(f"{c} {v}" for c, v in sorted(counts.items())))
    if not mix:
        print("sass: cuobjdump not found, the instruction mix is not checked")
    else:
        result["sass_folded"] = folded = sass_folded(mix)
        print("sass: every MUFU chain issues a full unrolled body" if not folded
              else f"sass: folded chains: {folded}")
    # issue slots: the f32 ops the card could issue per element in the time
    # one step of the op took
    c = card(dev.index or 0)
    slots = {op: r["ms"] * 1e-3 / (n * k) * FP32_PER_CLK * c["sms"]
             * c["clock_hz"] for op, r in rows.items()}
    pair = slots["sqrt"] + slots["div"]
    share = pair / (K2_FLOPS_PER_PAIR - 2 + pair)
    result["slots"], result["sqrt_div_share"] = slots, share
    print(f"finding: IEEE sqrtf + divide = {pair:.1f} f32 issue slots per "
          f"pair (sqrtf {slots['sqrt']:.1f}, divide {slots['div']:.1f}; "
          f"rsqrtf {slots['rsqrt']:.1f}, rcp.approx "
          f"{slots['recip_approx']:.1f}, mul {slots['mul']:.1f}); against "
          f"K2's {K2_FLOPS_PER_PAIR} flops per pair they are {share:.0%} of "
          f"its arithmetic issue; center term sqrt+div "
          f"{slots['center_now']:.1f} slots, sqrt+rcp~ "
          f"{slots['center_recip']:.1f}, rsqrt+rcp~ "
          f"{slots['center_rsqrt']:.1f}")
    return result


def cli(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
