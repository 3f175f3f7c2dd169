"""Named spans of the step, on the profiler's clock.

`span(name)` marks a phase of the step. Under `torch.profiler.profile` it
is a host event of that name in the profiler's timeline, beside the aten
ops, the CUDA runtime calls and the device kernels the same profiler
records, so the kernels and idle gaps of a trace can be put down to the
phase that launched them:

    with torch.profiler.profile(activities=[...CPU, ...CUDA]) as prof:
        model.step(3)
    prof.export_chrome_trace("step.json")

Without a profiler it returns one shared no-op context and records
nothing. The span is a host-only event (the `FUNCTION` scope of
`_RecordFunctionFast`): a `record_function` range is a user annotation,
which the CUDA profiler mirrors as a device-side event spanning the
range's kernels, and that would count as device work in a trace.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a host event while a profiler
    runs; the shared no-op otherwise."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
