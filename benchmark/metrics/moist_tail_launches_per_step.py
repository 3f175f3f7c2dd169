"""The moist tail's launches: the CUDA runtime calls that launch a kernel,
a copy or a fill from inside the program's `moist.*` spans, per traced
step. Nothing where the trace holds no such span."""

from benchmark import spans

UNIT = "launches/step"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def read(run):
    found = spans.spans(run.trace.host, ("moist.",))
    if not found:
        return None
    return (spans.calls_inside(run.trace.host, found, LAUNCH_CALLS)
            / run.trace.steps)
