"""How often the step ran as one replay of its CUDA graph: the program's
`step.graph` spans (one around each replay, dynamics/graph.py) in the
traced steps over the traced steps, in percent. Nothing where the trace
holds none, as a program that steps eagerly records none."""

from benchmark import spans

UNIT = "%"


def read(run):
    found = spans.spans(run.trace.host, ("step.graph",))
    if not found:
        return None
    return 100.0 * len(found) / run.trace.steps
