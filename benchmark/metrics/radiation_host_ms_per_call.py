"""The radiation's host time a call: the summed durations of the program's
`rad.*` spans (the columns, the SW and LW solves, the coupling into
rt_diabatic_tend) in the traced steps, over the radiation calls among them,
one `rad.sw` span each. Nothing where the trace holds no `rad.` span."""

from benchmark import spans

UNIT = "ms"


def read(run):
    found = spans.spans(run.trace.host, ("rad.",))
    calls = len(spans.spans(run.trace.host, ("rad.sw",)))
    if not found or not calls:
        return None
    return spans.host_us(found) / 1e3 / calls
