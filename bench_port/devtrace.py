"""``torch.profiler`` over one solve, reduced to what the per-layer
metrics and the trace breakdown read.

``capture`` runs a function under the profiler (CPU and CUDA activities)
and keeps each device operation's (name, start, end) and each top-level
host event's; ``reduce`` turns them into device seconds by name, the busy
seconds (the union of the device intervals), the host's top-level aten ops
(the count ``utils/profile_step._trace`` takes, copied) and the idle gaps
between device operations, each put down to the top-level host event that
was running at its midpoint.
"""

from __future__ import annotations

import bisect
import time

import torch

NAME_CHARS = 120  # kernel names are cut to this many characters


def capture(run, dev: torch.device) -> dict:
    """Run ``run()`` under the profiler; its wall seconds (host clock, the
    device synced), device spans and top-level host spans (seconds).  On
    the CPU (the tests) only host events are recorded."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        span = (e.name[:NAME_CHARS], e.time_range.start * 1e-6,
                e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        elif e.device_type == DeviceType.CPU and e.cpu_parent is None:
            host.append(span)
    return {"wall_s": wall, "device": device, "host": host}


def _merged(spans: list[tuple]) -> list[list[float]]:
    out: list[list[float]] = []
    for _, a, e in sorted(spans, key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([a, e])
    return out


def reduce(device: list[tuple], host: list[tuple]) -> dict:
    """Device seconds by operation name, busy seconds, host aten ops, and
    idle seconds between device operations by the host event running in
    the gap."""
    by_name: dict[str, float] = {}
    for name, a, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - a)
    busy = _merged(device)
    host = sorted(host, key=lambda s: s[1])
    starts = [s[1] for s in host]
    gaps: dict[str, float] = {}
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        name = (host[i][0] if i >= 0 and host[i][2] >= mid
                else "(host between events)")
        gaps[name] = gaps.get(name, 0.0) + (start - end)
    return {
        "device_s": by_name,
        "busy_s": sum(e - a for a, e in busy),
        "host_aten_ops": sum(1 for s in host if s[0].startswith("aten::")),
        "gaps_s": gaps,
    }


def top(by_name: dict[str, float], k: int = 10) -> list[list]:
    """The ``k`` largest entries as [[name, seconds], ...]."""
    names = sorted(by_name, key=by_name.get, reverse=True)[:k]
    return [[n, by_name[n]] for n in names]
