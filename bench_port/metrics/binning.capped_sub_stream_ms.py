"""Mean stream ms of one ``binning.capped_sub`` span (a binning's capped
sub frame: the rank and occupancy scans, the keep-sort, the reweighting
and the compaction), event to event on the card's stream, idle inside
included, in the profiled solve; None where the port opens no such span."""

import spans


def read(record: dict) -> float | None:
    ms = spans.stream_ms(record, "binning.capped_sub")
    return None if ms is None else sum(ms) / len(ms)
