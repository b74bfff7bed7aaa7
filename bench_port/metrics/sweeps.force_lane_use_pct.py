"""The share of lanes K2's pair terms keep busy, in the profiled solve: the
port's counter ``sweeps.force_pairs`` (the pairs K2's launches sum) over 32
times its counter ``sweeps.force_rounds`` (their warps' drain rounds: per
warp and staged piece, the most pairs of any one lane, each round issuing
the pair term once for the warp).  None where the port counts no drain
round (a port without the counters, or a path without K2)."""

import spans


def read(record: dict) -> float | None:
    got = spans.taken(record)
    counts = (got or {}).get("counts", {})
    pairs = counts.get("sweeps.force_pairs")
    rounds = counts.get("sweeps.force_rounds")
    if not pairs or not rounds or not rounds["total"]:
        return None
    return 100.0 * pairs["total"] / (32 * rounds["total"])
