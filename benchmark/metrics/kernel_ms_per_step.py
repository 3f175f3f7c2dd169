"""Device time of the operators and physics: the sum of the traced device
operations' durations, per step."""

UNIT = "ms"


def read(run):
    return sum(e - s for _, s, e in run.trace.device) / 1e3 / run.trace.steps
