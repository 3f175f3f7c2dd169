"""The window's 95th percentile step interval (CUDA events after each
step), read per layer in cells where the host's dispatch sets the pace of a
step and the tail swings with the host's speed from run to run."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(run.step_ms, 95))
