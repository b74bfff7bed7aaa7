"""Rebins a step over the window (``LazyCarry.rebin_count`` at the end of
each solve; a solve's initial binning is not counted)."""


def read(record: dict) -> float | None:
    if "profile" not in record:
        return None
    return record["rebins"] / record["steps"]
