"""The 95th percentile over every block of the window of the block's wall
time over its steps: ``run``'s ``step_ms`` per block (numpy's linear
percentile)."""

import numpy as np


def read(record: dict) -> float:
    return float(np.percentile(record["block_ms"], 95))
