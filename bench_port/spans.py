"""The port's own spans and counters of the profiled solve, read through
``smoothed_particle_hydrodynamics_tpu_torch.utils.trace.take()``.

The port records them only while ``torch.profiler`` runs, which in a run of
the benchmark is the profiled solve of ``--trace 1`` (stretch 3).  The
first reader of a run takes them and keeps them in the run's record, so
the other readers of that run share them and runs in one process do not
mix.  A port without the trace module, or a run without a profiled solve,
gives None.
"""

from __future__ import annotations

KEY = "port_trace"


def taken(record: dict) -> dict | None:
    """{"spans", "counts", "dropped"} of the record's profiled solve (see
    ``utils/trace.take``), or None where there is nothing to read."""
    if "profile" not in record:
        return None
    if KEY not in record:
        try:
            from smoothed_particle_hydrodynamics_tpu_torch.utils import trace
        except ImportError:
            record[KEY] = None
        else:
            got = trace.take()
            record[KEY] = got if got["spans"] or got["counts"] else None
    return record[KEY]


def host_ms(record: dict, name: str) -> float | None:
    """Host ms summed over the spans named ``name``; None without any."""
    got = taken(record)
    spans = [s for s in got["spans"] if s["name"] == name] if got else []
    if not spans:
        return None
    return sum(s["host_ns"][1] - s["host_ns"][0] for s in spans) * 1e-6


def stream_ms(record: dict, name: str) -> list[float] | None:
    """The stream ms (event to event) of each span named ``name``; None
    without any, or where they were not timed on a CUDA stream."""
    got = taken(record)
    spans = [s for s in got["spans"] if s["name"] == name] if got else []
    if not spans or any(s["stream_ms"] is None for s in spans):
        return None
    return [s["stream_ms"][1] - s["stream_ms"][0] for s in spans]
