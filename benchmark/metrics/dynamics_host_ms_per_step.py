"""The step driver's host time: the summed durations of the program's
`srk3.*` spans (the phases of `atm_srk3`'s dry dynamics, dynamics/srk3.py)
in the traced steps, per step. Nothing where the trace holds none."""

from benchmark import spans

UNIT = "ms"


def read(run):
    found = spans.spans(run.trace.host, ("srk3.",))
    if not found:
        return None
    return spans.host_us(found) / 1e3 / run.trace.steps
