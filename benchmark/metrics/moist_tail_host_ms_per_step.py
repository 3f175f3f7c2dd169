"""The moist tail's host time: the summed durations of the program's
`moist.*` spans (scalar transport, microphysics, PBL) in the traced steps,
per step. Nothing where the trace holds none."""

from benchmark import spans

UNIT = "ms"


def read(run):
    found = spans.spans(run.trace.host, ("moist.",))
    if not found:
        return None
    return spans.host_us(found) / 1e3 / run.trace.steps
