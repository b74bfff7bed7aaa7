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
term, and prints per op: ms (queued CUDA events, 3 warmup + 20 timed
runs), G op/s, the cost relative to mul, and the op's bound with the op's
share of it.  The bound is counted from the built SASS (``cuobjdump``):
the instructions of the chain's 16-step unrolled loop body on its fast
path (``sass_body_mix``; the IEEE sequences' slow paths, which the inputs
never take, left out), by class, a step; then the largest of the bytes
over the HBM rate, the MUFU instructions over 16 a clock a SM, the integer
ones over 64 and the three classes together over 128 lane-issues a clock a
SM (control, the compiler's BSSY/BSYNC/branches, left out), at the SM
count and maximum SM clock the run reads (``counted_bound``).  Then the
approximate reciprocal's relative error over d in [1e-3, 4] (K = 1), the
instruction mix of each chain (``sqrtf`` and ``/`` must stay IEEE
sequences, and every chain must issue its MUFU instructions, not fold),
and the findings.

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
from . import (FP32_PER_CLK, HBM_BYTES_PER_S, INT_PER_CLK, ISSUE_PER_CLK,
               MUFU_PER_CLK, card, kernels, resolve_device, time_ms)

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
# the least f32 add/mul and MUFU instructions one step issues (IEEE sqrtf,
# divide and __frcp_rn counted as their one MUFU op, not their refinement;
# the approximate reciprocal's step adds the opaque zero, csrc/probes.cu):
# a floor that the counted unrolled body (sass_body_mix) must reach
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


def sass_listing() -> str:
    """The built probes library's SASS (``cuobjdump -sass``, from the CUDA
    toolkit beside nvcc)."""
    tool = shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).exists():
        raise RuntimeError(f"no cuobjdump beside nvcc ({tool}): the chain "
                           "kernels' bounds are counted from their SASS")
    kernels()  # built
    return subprocess.run([tool, "-sass", str(build.library_path("probes"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


_FUNCTION = re.compile(r"Function : \S*chain_kernelILi(\d+)E")
_INSTR = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                    r"([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def _chain_functions(listing: str) -> dict:
    """Per chain op, its kernel's instructions in order: (address,
    predicated, opcode, branch target or None)."""
    funcs, op = {}, None
    for line in listing.splitlines():
        if "Function :" in line:
            m = _FUNCTION.search(line)
            op = OPS[int(m.group(1))] if m else None
            if op:
                funcs[op] = []
            continue
        m = _INSTR.match(line)
        if op and m:
            t = _TARGET.search(m.group(4)) if m.group(3).startswith("BRA") \
                else None
            funcs[op].append((int(m.group(1), 16), bool(m.group(2)),
                              m.group(3), int(t.group(1), 16) if t else None))
    return funcs


def sass_mix(listing: str) -> dict:
    """Per chain op, its whole kernel's f32, MUFU and control instructions
    in ``listing`` (``sass_listing``)."""
    return {op: collections.Counter(
                ins for _, _, ins, _ in body
                if ins.startswith(("MUFU", "F", "CALL", "BRA")))
            for op, body in _chain_functions(listing).items()}


# a slow path behind a predicated branch: a few instructions, a CALL among
# them (the IEEE sequences' out-of-range operands); a branch over one is
# the fast path
SLOW_PATH = 4


def _slow(code: list, start: int, stop: int) -> bool:
    """Whether the instructions ``code[start:]`` below address ``stop`` are
    a slow path."""
    block = [ins for addr, _, ins, _ in code[start:start + SLOW_PATH + 1]
             if addr < stop]
    return len(block) <= SLOW_PATH and any(b.startswith("CALL")
                                           for b in block)


def _loop_body(code: list, at: dict, head: int) -> tuple[list, bool] | None:
    """The instructions one pass of the loop at ``head`` issues on its fast
    path: from the head to the branch back to it, a predicated branch over
    a slow path taken, other predicated forward branches (to out-of-line
    slow paths among them) not, unpredicated ones followed.  Also whether
    the pass crosses the back edge of another loop (so the loop is not
    innermost).  None when the pass leaves the function or cycles without
    returning to the head."""
    i, body, inner, seen = at[head], [], False, set()
    while i < len(code) and i not in seen:
        seen.add(i)
        addr, pred, ins, tgt = code[i]
        body.append(ins)
        if ins.startswith(("EXIT", "RET")) and not pred:
            return None
        if ins.startswith("BRA") and tgt is not None:
            if tgt == head:
                return body, inner
            if not pred:
                i = at.get(tgt, len(code))
                continue
            if tgt < addr:
                inner = True
            elif _slow(code, i + 1, tgt):
                i = at[tgt]
                continue
        i += 1
    return None


def sass_body_mix(listing: str) -> dict:
    """Per chain op, the instructions of its unrolled loop body (``UNROLL``
    steps) in ``listing`` by opcode: of the loops whose body holds no other
    loop, the one with the most f32 and MUFU instructions (the chain's;
    the others copy or count).  The remainder steps and the grid-stride
    loop's own instructions are left out, as are the slow paths that the
    IEEE sequences branch to and the probe's inputs never take."""
    def arithmetic(body):
        return sum(sass_class(ins) in ("fp32", "mufu") for ins in body)

    out = {}
    for op, code in _chain_functions(listing).items():
        at = {addr: i for i, (addr, *_rest) in enumerate(code)}
        best = ()
        for addr, _, ins, tgt in code:
            if ins.startswith("BRA") and tgt is not None and tgt <= addr \
                    and tgt in at:
                found = _loop_body(code, at, tgt)
                if found and not found[1] and (arithmetic(found[0]), len(
                        found[0])) > (arithmetic(best), len(best)):
                    best = found[0]
        out[op] = collections.Counter(best)
    return out


FP32_SASS = ("FADD", "FMUL", "FFMA", "FCHK", "FSETP", "FSEL", "FMNMX", "FSET")
INT_SASS = ("IADD3", "VIADD", "ISETP", "LOP3", "IMAD", "SHF", "LEA", "SEL",
            "MOV", "IABS", "IMNMX", "VIMNMX", "PRMT", "PLOP3", "POPC", "FLO")
CONTROL_SASS = ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "NOP")


def sass_class(ins: str) -> str:
    """The class of a SASS opcode: fp32, mufu, int, control or other."""
    base = ins.split(".")[0]
    if base == "MUFU":
        return "mufu"
    for name, group in (("fp32", FP32_SASS), ("int", INT_SASS),
                        ("control", CONTROL_SASS)):
        if base in group:
            return name
    return "other"


def step_mix(body: collections.Counter) -> dict:
    """Instructions per chain step by class (the unrolled body over
    ``UNROLL``); ``work``, the step's own arithmetic (f32, MUFU and
    integer: the IEEE sequences' refinement and range checks among them),
    and ``all``, control and the rest too."""
    per = collections.Counter()
    for ins, count in body.items():
        per[sass_class(ins)] += count
    step = {c: per[c] / UNROLL for c in ("fp32", "mufu", "int", "control",
                                         "other")}
    step["work"] = step["fp32"] + step["mufu"] + step["int"]
    step["all"] = sum(per.values()) / UNROLL
    return step


def counted_bound(steps: float, nbytes: int, step: dict, sms: int,
                  clock_hz: float) -> dict:
    """The least time for ``steps`` chain steps and ``nbytes`` of device
    memory, from the counted body: the largest of the bytes over the HBM
    rate, the MUFU instructions over 16 per clock per SM, the integer ones
    over 64 and the step's own arithmetic (``work``: f32, MUFU and
    integer) over 128 lane-issues per clock per SM (4 schedulers, one warp
    instruction each), at the card's SM count and maximum clock.  Control
    (BSSY, BSYNC, branches) is left out: it is the compiler's layout of
    the branches, not the function's work, and whether it takes issue
    slots is not measured.  ``ms``, ``by`` (which of the four) and each
    part."""
    rate = sms * clock_hz
    parts = dict(bytes=nbytes / HBM_BYTES_PER_S * 1e3,
                 mufu=steps * step["mufu"] / (MUFU_PER_CLK * rate) * 1e3,
                 int=steps * step["int"] / (INT_PER_CLK * rate) * 1e3,
                 issue=steps * step["work"] / (ISSUE_PER_CLK * rate) * 1e3)
    by = max(parts, key=parts.get)
    return dict(ms=parts[by], by=by, parts=parts)


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
    if on_card:
        c = card(dev.index or 0)
        listing = sass_listing()
        body = sass_body_mix(listing)
    rows, base = {}, None
    for op in OPS:
        ms = time_ms(lambda: chain(x, op, k), dev)
        row = dict(ms=ms, gops=n * k / ms / 1e6)
        line = f"{LABELS[op]:28s} {ms:8.3f} ms  {row['gops']:7.1f} Gop/s"
        if base is not None:
            row["x_mul"] = ms / base
            line += f"  {row['x_mul']:5.2f}x mul"
        if on_card:
            row["step"] = step = step_mix(body[op])
            b = counted_bound(n * k, 2 * x.nbytes, step, c["sms"],
                              c["clock_hz"])
            row["bound_ms"], row["bound_class"] = b["ms"], b["by"]
            row["bound_by"] = "bytes" if b["by"] == "bytes" else "operations"
            row["bound_parts"], row["share"] = b["parts"], b["ms"] / ms
            line += (f"  bound {b['ms'] * 1e3:7.1f} us ({b['by']}; a step "
                     f"{step['work']:.2f} instructions of work: fp32 "
                     f"{step['fp32']:.2f}, mufu {step['mufu']:.2f}, int "
                     f"{step['int']:.2f}; control {step['control']:.2f} "
                     f"not counted)  "
                     f"{row['share']:.0%} of it")
        print(line)
        rows[op] = row
        base = ms if base is None else base
    d = recip_table(dev)
    err = recip_rel_err(d, chain(d, "recip_approx", 1))
    print(f"recip approx rel err: max {err[0]:.3e} mean {err[1]:.3e}")
    result = dict(ops=rows, recip_err=err, n=n, k=k, device=str(dev))
    if not on_card:
        return result
    result["sass"] = mix = sass_mix(listing)
    result["sass_body"] = body
    for op, counts in mix.items():
        print(f"sass chain_kernel<{op}>: "
              + " ".join(f"{c} {v}" for c, v in sorted(counts.items())))
    for op, counts in body.items():
        print(f"sass chain_kernel<{op}> unrolled body ({UNROLL} steps): "
              + " ".join(f"{c} {v}" for c, v in sorted(counts.items())))
    result["sass_folded"] = folded = sass_folded(mix)
    print("sass: every MUFU chain issues a full unrolled body" if not folded
          else f"sass: folded chains: {folded}")
    # issue slots: the f32 ops the card could issue per element in the time
    # one step of the op took
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
