"""Mean stream ms of one ``binning.prepare`` span (the solve's initial
binning and each rebin), event to event on the card's stream, idle inside
included, in the profiled solve."""

import spans


def read(record: dict) -> float | None:
    ms = spans.stream_ms(record, "binning.prepare")
    return None if ms is None else sum(ms) / len(ms)
