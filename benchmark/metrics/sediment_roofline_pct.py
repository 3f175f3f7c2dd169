"""Kernel 5 (csrc/sediment.cu): the least time its launches could take,
from the frozen byte and operation count of the species the cell's
microphysics sediments, at the step's (K, C, nfall, dtype), over their
traced device time. Nothing where the trace holds no launch of it."""

from benchmark import work

UNIT = "%"
KERNEL = "sediment_kernel"


def read(run):
    spans = [e - s for name, s, e in run.trace.device if KERNEL in name]
    if not spans:
        return None
    z = run.sizes
    nbytes, flops = work.sediment(z["K"], z["nCells"],
                                  work.FALLING[z["microphysics"]], z["nfall"],
                                  z["itemsize"])
    least = work.bound_seconds(nbytes, flops, z["dtype"]) * len(spans)
    return 100.0 * least / (sum(spans) / 1e6)
