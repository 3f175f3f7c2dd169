"""The radiation's launches a call: the CUDA runtime calls that launch a
kernel, a copy or a fill from inside the program's `rad.*` spans in the
traced steps, over the radiation calls among them, one `rad.sw` span each.
Nothing where the trace holds no `rad.` span."""

from benchmark import spans

UNIT = "launches/call"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def read(run):
    found = spans.spans(run.trace.host, ("rad.",))
    calls = len(spans.spans(run.trace.host, ("rad.sw",)))
    if not found or not calls:
        return None
    return spans.calls_inside(run.trace.host, found, LAUNCH_CALLS) / calls
