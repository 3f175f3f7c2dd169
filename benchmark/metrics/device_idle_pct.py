"""The device's idle share of the traced steps: 100 less the union of the
device operations' intervals over the traced wall time."""

UNIT = "%"


def read(run):
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.wall_s)
