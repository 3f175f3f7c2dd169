"""The host's cost of one launch in the step: the host time inside the
program's `srk3.*` and `moist.*` spans over the CUDA runtime calls that
launch a kernel, a copy or a fill from inside them. Nothing where the trace
holds no such span or no launch inside one."""

from benchmark import spans

UNIT = "us"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def read(run):
    found = spans.spans(run.trace.host, ("srk3.", "moist."))
    launches = spans.calls_inside(run.trace.host, found, LAUNCH_CALLS)
    if not launches:
        return None
    return spans.host_us(found) / launches
