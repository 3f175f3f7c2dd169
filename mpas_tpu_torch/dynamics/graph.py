"""The step as one CUDA graph.

On the card, `Model.step` runs its step function eagerly once, then
captures the next step (all three RK stages, the acoustic substeps, the
split finish and the moist tail) as one CUDA graph over buffers of its own,
one per field of the state, and from then on replays that graph, one
launch a step, in place of the ~2,400 (dry) to ~3,900 (moist) launches
that the host would otherwise issue one at a time. The kernels, their order
and their arithmetic are those of the eager step, so a replayed step is bit
for bit the eager one.

A graph reads and writes fixed addresses, so the state it advances lives in
its buffers (`StepGraph.state`): each replay overwrites them, and a caller
that keeps a state across steps clones it. A field of `model.state` that is
not the graph's buffer (the radiation's new heating, a state the caller
assigned) is copied into the buffer before the replay. A new step function,
or a field whose shape, dtype or presence changes, drops the graph: the
next step runs eagerly and the one after captures again.

The CPU has no graphs and steps eagerly, unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from ..tracing import span


def tensor_fields(state) -> dict:
    """{name: tensor} of the state's fields that are tensors."""
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if torch.is_tensor(getattr(state, f.name))}


def signature(state) -> tuple:
    """What a graph over the state's buffers fixes: each field's shape,
    dtype and device, or None where the field is absent."""
    return tuple(
        (tuple(t.shape), t.dtype, t.device) if torch.is_tensor(t) else None
        for t in (getattr(state, f.name) for f in dataclasses.fields(state)))


def engages(state) -> bool:
    """Whether `Model.step` steps `state` through a graph: on the card."""
    return state.theta_m.is_cuda


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def copy_into(buffers: dict, sources: dict):
    """buffers[name].copy_(sources[name]) for each name whose source is not
    its buffer already. A source that shares storage with a buffer written
    here (another field's, or its own as a view) is cloned first, so no
    buffer is overwritten before it is read."""
    todo = {n: t for n, t in sources.items() if t is not buffers[n]}
    written = {_storage(buffers[n]) for n in todo}
    staged = {n: (t.clone() if _storage(t) in written else t)
              for n, t in todo.items()}
    for n, t in staged.items():
        buffers[n].copy_(t)


class StepGraph:
    """`step_fn` captured over buffers cloned from `state`; `state` is the
    State of those buffers, which each `replay` advances by one step."""

    def __init__(self, step_fn, state):
        self.step_fn = step_fn
        self.key = signature(state)
        # one buffer per field, no two sharing storage
        self.state = state.replace(
            **{n: t.clone() for n, t in tensor_fields(state).items()})

    def step_in_place(self):
        """What the graph records: one step from the buffers, its outputs
        copied back into them (`advance` captures only a step whose eager
        run kept every field's shape, dtype and presence). No reference to
        the outputs outlives the call, so under a capture their blocks stay
        free in the graph's pool."""
        out = self.step_fn(self.state)
        copy_into(tensor_fields(self.state), tensor_fields(out))

    def capture(self):
        """Record `step_in_place` as `self.graph`. Records only: the
        buffers are not advanced."""
        from torch.profiler import _utils as profiler_utils
        # the profiler must have been initialised before a capture to see
        # the graph's kernels in a later trace
        profiler_utils._init_for_cuda_graphs()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.step_in_place()

    def replay(self, state):
        """Copy in the fields of `state` that are not the buffers, replay
        one step, and return the buffers' State."""
        copy_into(tensor_fields(self.state), tensor_fields(state))
        with span("step.graph"):
            self.graph.replay()
        return self.state


def advance(model):
    """One step of `model` on the card: a replay of its graph where the
    graph fits the step function and the state, else an eager step, after
    which the next step captures."""
    state, graph = model.state, model._graph
    key = (model.step_fn, signature(state))
    if graph is not None and (graph.step_fn, graph.key) == key:
        model.state = graph.replay(state)
        model.graph_replays += 1
        return
    model._graph = None
    if model._graph_warm != key:
        # an eager step first: it fills the caches (index statistics, the
        # kernels' library) that a capture may not fill
        out = model.step_fn(state)
        model._graph_warm = key if signature(out) == key[1] else None
        model.state = out
        return
    graph = StepGraph(model.step_fn, state)
    # the old state goes before the capture, so the buffers take its place
    # in the step's peak memory
    model.state = graph.state
    del state
    graph.capture()
    model.graph_captures += 1
    model._graph = graph
    model.state = graph.replay(graph.state)
    model.graph_replays += 1
