"""Seconds from the start of the process to the first timed step: imports,
the card's start, the initial conditions, the first run's build of the
CUDA libraries, and the warm-up block."""


def read(record: dict) -> float:
    return record["setup_s"]
