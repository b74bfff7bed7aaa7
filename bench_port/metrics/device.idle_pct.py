"""Share of the untraced step in which the card runs nothing: 100 times
(1 - device ms a step in the profiled solve, the union of its operations,
over the window's untraced ms a step)."""


def read(record: dict) -> float | None:
    prof = record.get("profile")
    if not prof or not prof["busy_s"]:
        return None
    busy_ms = prof["busy_s"] * 1e3 / prof["steps"]
    return 100.0 * (1.0 - busy_ms / record["untraced_ms_per_step"])
