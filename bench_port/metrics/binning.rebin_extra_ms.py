"""Host ms a step that binned (a rebin or the solve's initial binning)
takes beyond a steady step, from the solve timed a step at a time with a
device sync around each step."""


def read(record: dict) -> float | None:
    ms, binned = record.get("step_ms"), record.get("binned")
    if not ms:
        return None
    rebin = [t for t, b in zip(ms, binned) if b]
    steady = [t for t, b in zip(ms, binned) if not b]
    if not rebin or not steady:
        return None
    return sum(rebin) / len(rebin) - sum(steady) / len(steady)
