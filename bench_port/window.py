"""Whole solves: the timed window and the traced run's stretches.

A solve is what a user's run of the scene does: ``steps`` steps from the
initial state, in blocks of ``block`` steps through the port's lazy driver,
each block closed by a device sync and the host's read of its diagnostics,
as ``run`` does.  Every solve starts from a fresh copy of the same initial
state, kept on the device, so every solve covers the same stretch of the
flow whatever the program's speed.

The steps whose outputs the reference checks are drawn from the seed
before the window opens: a block that holds one runs as up to three
chained calls of the driver (the steps before it, the step, the steps
after), and the state before that step and what it produced are copied on
the device (in capped mode with the bins it used, ``port.BinFrames``).
Nothing else differs from the other blocks.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

import port


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def draw_checks(seed: int, count: int, solves: int, steps: int,
                block: int) -> dict:
    """{(solve, block index): step offset in the block} of ``count``
    checked steps: the first step of the first solve (its initial
    binning), and the rest drawn from ``seed`` over the first ``solves``
    solves, one at most in a block."""
    blocks = -(-steps // block)
    rng = random.Random(seed)
    picks = {(0, 0): 0}
    while len(picks) < min(count, solves * blocks):
        key = (rng.randrange(solves), rng.randrange(blocks))
        if key not in picks:
            picks[key] = rng.randrange(min(block, steps - key[1] * block))
    return picks


def solve(cfg, init, steps: int, block: int, dev: torch.device,
          checks: dict | None = None, index: int = 0,
          sink: list | None = None) -> dict:
    """One whole solve from ``init``.  ``checks`` and ``index`` say which
    of its steps to copy into ``sink``.  Returns its blocks' ms/step,
    failed steps, rebins and per-step mean neighbor counts."""
    checks = checks or {}
    state, carry = port.fresh(init), None
    done = b = failed = 0
    block_ms, neighbor_mean = [], []
    with port.BinFrames(cfg) as frames:
        while done < steps:
            n = min(block, steps - done)
            t0 = time.perf_counter()
            j = checks.get((index, b))
            if j is None:
                carry, diags = port.advance(cfg, state, carry, n)
            else:
                parts = []
                if j:
                    carry, d = port.advance(cfg, state, carry, j)
                    parts.append(d)
                pre = port.before(state, carry)
                carry, d = port.advance(cfg, state, carry, 1)
                parts.append(d)
                sink.append({"solve": index, "step": done + j, "before": pre,
                             "after": port.after(carry, frames)})
                if n - j - 1:
                    carry, d = port.advance(cfg, state, carry, n - j - 1)
                    parts.append(d)
                diags = port.concat(parts)
            sync(dev)
            block_ms.append((time.perf_counter() - t0) * 1e3 / n)
            state = None  # the carry holds the solve from here on
            host = port.read_block(diags)
            failed += port.failed_steps(host)
            neighbor_mean.extend(np.asarray(host["neighbor_mean"]).tolist())
            done += n
            b += 1
    return {"block_ms": block_ms, "failed": failed,
            "rebins": port.rebins(carry), "neighbor_mean": neighbor_mean}


def timed_window(cfg, init, steps: int, block: int, seconds: float,
                 dev: torch.device, checks: dict, sink: list) -> dict:
    """Whole solves back to back: the first always, and each further one
    only while the time left holds one more at the slowest solve time
    seen so far."""
    t0 = time.perf_counter()
    solves, times = [], []
    while True:
        ts = time.perf_counter()
        solves.append(solve(cfg, init, steps, block, dev, checks,
                            len(solves), sink))
        te = time.perf_counter()
        times.append(te - ts)
        if seconds - (te - t0) < max(times):
            break
    return {
        "window_s": te - t0,
        "solves": len(solves),
        "solve_s": times,
        "steps": steps * len(solves),
        "block_ms": [m for s in solves for m in s["block_ms"]],
        "failed": sum(s["failed"] for s in solves),
        "rebins": sum(s["rebins"] for s in solves),
    }


def per_step(cfg, init, steps: int, dev: torch.device) -> dict:
    """One solve a step at a time, a device sync around each step: each
    step's host ms and whether it binned (the initial binning, or a
    rebin)."""
    state, carry = port.fresh(init), None
    ms, binned, prev = [], [], 0
    for k in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        carry, _ = port.advance(cfg, state, carry, 1)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        rb = port.rebins(carry)
        binned.append(k == 0 or rb > prev)
        prev, state = rb, None
    return {"step_ms": ms, "binned": binned}
