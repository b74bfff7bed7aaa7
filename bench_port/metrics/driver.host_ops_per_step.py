"""Top-level aten ops the host issues a step, in the profiled solve."""


def read(record: dict) -> float | None:
    prof = record.get("profile")
    return prof["host_aten_ops"] / prof["steps"] if prof else None
