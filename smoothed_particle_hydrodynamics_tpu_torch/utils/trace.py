"""Spans and counters inside the port's step, on the profiler's clock.

They record only while a ``torch.profiler`` session runs (the flag
``torch.autograd.profiler._is_profiler_enabled``, which torch keeps for such
checks), so that a profiled run can join them with its device trace.
Otherwise ``span`` hands back one shared no-op context and ``count``
returns at once: no allocation, no CUDA call, no sync.

- ``span(name, dev)``, a context manager, records its name, its parent's,
  the step id (the number of the enclosing ``driver.step`` span, in the
  order they opened; None outside one), its host start and end in
  ``time.time_ns()``'s epoch, the one in which the profiler stamps its
  trace start (``kineto_results.trace_start_ns()``; ``FunctionEvent``
  times are µs from it), and, on a CUDA device, its stream interval:
  timing events recorded on the current stream at its boundaries, read
  only by ``take``.  Spans tile their parent: a span with children issues
  its device work inside them, so only a root's open and a leaf's close
  record an event, and every other boundary shares the one before it.
- ``count(name, value)`` adds ``value`` to a counter.  A device scalar
  counted again is kept once with its multiplicity, so a count a step
  adds no device op.
- ``hidden()`` keeps the host ops inside it out of the profiler's events
  (their kernels stay in its device trace): for work done only to count.

Neither a span nor ``hidden`` adds an event to the profiler's tree: no
``record_function``, no NVTX.  ``take()`` returns what was recorded and
clears it; ``gaps_by_span`` puts a device trace's idle gaps down to spans.
"""

from __future__ import annotations

import bisect
import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

STEP = "driver.step"        # the span whose opens number the steps
OUTSIDE = "(outside any span)"
MAX_SPANS = 1 << 16         # spans kept until ``take``; later ones dropped

_NULL = contextlib.nullcontext()

_spans: list[list] = []     # [name, up, step, t0, t1, ev0, ev1, kids]
_stack: list[int] = []      # indices of the open spans
_events: list = []          # this session's events, in record order
_pool: list = []            # events free for reuse
_devices: set = set()
_counts: dict[str, list[list]] = {}
_tail = [None]              # index in _events of the last boundary's event
_state = {"step": 0, "dropped": 0}


def recording() -> bool:
    """True while a ``torch.profiler`` session runs."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "dev", "idx")

    def __init__(self, name: str, dev):
        self.name, self.dev, self.idx = name, dev, None

    def __enter__(self):
        if len(_spans) >= MAX_SPANS:
            _state["dropped"] += 1
            return self
        up = _stack[-1] if _stack else -1
        if up >= 0:
            _spans[up][7] = True
            step = _spans[up][2]
        else:
            step = None
        if self.name == STEP:
            _state["step"] += 1
            step = _state["step"]
        ev = None
        if self.dev is not None and self.dev.type == "cuda":
            ev = _record(self.dev) if up < 0 else _tail[0]
        self.idx = len(_spans)
        _spans.append([self.name, up, step, time.time_ns(), None, ev, None,
                       False])
        _stack.append(self.idx)
        return self

    def __exit__(self, *exc):
        if self.idx is None:
            return False
        s = _spans[self.idx]
        if s[5] is not None:
            s[6] = _tail[0] if s[7] else _record(self.dev)
        s[4] = time.time_ns()
        _stack.pop()
        if not _stack:
            _tail[0] = None
        return False


def _record(dev) -> int:
    ev = _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    _devices.add(dev)
    _events.append(ev)
    _tail[0] = len(_events) - 1
    return _tail[0]


def span(name: str, dev: torch.device | None = None):
    """A span named ``name`` over the work of a ``with`` block on device
    ``dev`` (its stream interval is timed where ``dev`` is a CUDA device);
    the shared no-op context while nothing records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, dev)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while recording; ``value`` is
    a number or a 0-d tensor (read only by ``take``), None counts
    nothing."""
    if not _profiler._is_profiler_enabled or value is None:
        return
    entries = _counts.setdefault(name, [])
    if entries and entries[-1][0] is value:
        entries[-1][1] += 1
    else:
        entries.append([value, 1])


@contextlib.contextmanager
def hidden():
    """Keep the host ops inside out of the profiler's events while
    recording (their device kernels stay in its trace)."""
    torch._C._autograd._enable_record_function(False)
    try:
        yield
    finally:
        torch._C._autograd._enable_record_function(True)


def take() -> dict:
    """What was recorded since the last ``take``, and clear it:

    - ``spans``: in the order they opened, each a dict of ``name``,
      ``parent`` (a name, None for a root), ``up`` (the parent's index in
      the list, -1 for a root), ``step``, ``host_ns`` (start, end) and
      ``stream_ms`` (start, end) from the session's first event, None off
      CUDA; a span still open is left out;
    - ``counts``: {name: {"total": the sum of the values counted,
      "times": how many were}};
    - ``dropped``: spans not kept (the buffer holds ``MAX_SPANS``).

    Syncs the devices the events were recorded on: call it once recording
    has ended."""
    for dev in _devices:
        torch.cuda.synchronize(dev)
    ms = ([_events[0].elapsed_time(e) for e in _events] if _events else [])
    keep = [s for s in _spans if s[4] is not None]
    new_index = {id(s): i for i, s in enumerate(keep)}
    spans = []
    for s in keep:
        up = _spans[s[1]] if s[1] >= 0 else None
        spans.append({
            "name": s[0], "parent": up[0] if up else None,
            "up": new_index.get(id(up), -1) if up else -1, "step": s[2],
            "host_ns": (s[3], s[4]),
            "stream_ms": (None if s[5] is None or s[6] is None
                          else (ms[s[5]], ms[s[6]]))})
    counts = {}
    for name, entries in _counts.items():
        total = sum(float(v) * k for v, k in entries)
        counts[name] = {"total": total, "times": sum(k for _, k in entries)}
    out = {"spans": spans, "counts": counts, "dropped": _state["dropped"]}
    _pool.extend(_events)
    _events.clear()
    _spans.clear()
    _stack.clear()
    _devices.clear()
    _counts.clear()
    _tail[0] = None
    _state.update(step=0, dropped=0)
    return out


def _merged(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, e in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([a, e])
    return out


def gaps_by_span(device_intervals, spans: list[dict], origin_ns: int = 0,
                 keep=None) -> dict[str, float]:
    """{span name: idle seconds}: each gap between the merged
    ``device_intervals`` ((start, end) seconds from ``origin_ns``, the
    profiler's trace start: ``FunctionEvent.time_range`` times 1e-6) put
    down to the innermost of ``spans`` (``take()["spans"]``) whose host
    interval holds the gap's midpoint, else to ``OUTSIDE``; with ``keep``,
    only the gaps whose midpoint it accepts."""
    starts = [(s["host_ns"][0] - origin_ns) * 1e-9 for s in spans]
    gaps: dict[str, float] = {}
    busy = _merged(device_intervals)
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = 0.5 * (end + start)
        if keep is not None and not keep(mid):
            continue
        i = bisect.bisect_right(starts, mid) - 1
        # spans nest: one that holds mid and opened before span i holds i
        while i >= 0 and (spans[i]["host_ns"][1] - origin_ns) * 1e-9 < mid:
            i = spans[i]["up"]
        name = spans[i]["name"] if i >= 0 else OUTSIDE
        gaps[name] = gaps.get(name, 0.0) + (start - end)
    return gaps
