"""The step driver's launches: device operations in the traced steps, per
step."""

UNIT = "launches/step"


def read(run):
    return len(run.trace.device) / run.trace.steps
