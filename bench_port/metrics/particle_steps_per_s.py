"""Particle-steps per second of the window: N times the steps of all its
whole solves, over its wall time (host clock, ending in a device sync)."""


def read(record: dict) -> float:
    return record["particles"] * record["steps"] / record["window_s"]
