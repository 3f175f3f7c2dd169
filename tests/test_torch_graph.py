"""The step as one CUDA graph (mpas_tpu_torch/dynamics/graph.py).

On the CPU, which has no graphs:
  - a CPU model never captures and steps exactly as `step_fn` does;
  - `copy_into` stages a source that shares storage with a buffer it
    writes (a swap of two fields, a view of a field's own buffer);
  - `Model.step`'s graph path with the capture faked (the "graph" is
    `StepGraph.step_in_place` itself, run at each replay), float64 on
    generate_mesh(2): 5 steps are 1 eager step, 1 capture and 4 replays
    and equal 5 eager steps bit for bit, dry and JW + WSM6 + PBL with
    condensate seeded; a state assigned between two replays is the one the
    next step reads; radiation ringing every 2 steps rings on eager and
    replayed steps alike; a new step function or a field that appears
    drops the graph, steps eagerly once and captures again; each replay is
    one `step.graph` span, which the benchmark's `graph_replay_share`
    reads as 100.

On the card (marked gpu, skipped without one), float32 on
generate_mesh(3): the same runs with the real graph, every field
`torch.equal` to the eager steps. The file imports no JAX, so on a machine
with a card it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_graph.py
"""

import dataclasses
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics import graph as step_graph
from mpas_tpu_torch.dynamics.model import build_model, radiation_rings
from mpas_tpu_torch.mesh.generator import generate_mesh
from mpas_tpu_torch.probes import seeded_condensate

ROOT = Path(__file__).resolve().parents[1]

MOIST = dict(config_moisture=True, config_microphysics="wsm6",
             config_pbl="ysu_lite")
RAD = dict(config_radt_lw_scheme="cam_lw", config_radt_sw_scheme="cam_sw",
           config_radtlw_interval=600.0, config_radtsw_interval=600.0)
KINDS = {"dry": {}, "moist": MOIST}
STEPS = 5


def namelist(dtype, levels, **changes):
    return Namelist(config_nvertlevels=levels, config_ztop=30000.0,
                    config_dt=300.0, dtype=dtype,
                    config_jw_u_perturbation=1.0, **changes)


def clone(state):
    return state.replace(**{n: t.clone() for n, t in
                            step_graph.tensor_fields(state).items()})


def unequal_fields(a, b) -> list:
    """Names of the fields in which states a and b differ in any bit."""
    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None) or (
                x is not None and not torch.equal(x, y)):
            out.append(f.name)
    return out


def eager(model, state, steps, first=0):
    """`steps` eager steps of `model.step_fn` from `state` at step count
    `first`, with the radiation of `model` where its alarm rings."""
    ref = SimpleNamespace(model=model, state=state)
    for n in range(first, first + steps):
        if model.radiation_interval is not None and radiation_rings(
                n, model.namelist.config_dt, model.radiation_interval):
            saved = model.state, model.step_count
            model.state, model.step_count = ref.state, n
            model.radiate()
            ref.state = model.state
            model.state, model.step_count = saved
        ref.state = model.step_fn(ref.state)
    return ref.state


def seeded(model):
    if model.state.scalars is not None:
        model.state = seeded_condensate(model.state, seed=3)
    return model


# ---- the CPU ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2():
    return generate_mesh(levels=2)


@pytest.fixture
def faked(monkeypatch):
    """Model.step's graph path on the CPU: the capture records nothing and
    a replay runs `step_in_place`, the work a capture would record."""
    monkeypatch.setattr(step_graph, "engages", lambda state: True)
    monkeypatch.setattr(
        step_graph.StepGraph, "capture",
        lambda self: setattr(self, "graph",
                             SimpleNamespace(replay=self.step_in_place)))


def cpu_model(mesh, kind="dry", **changes):
    return seeded(build_model(namelist("float64", 6, **KINDS[kind],
                                       **changes), mesh, device="cpu"))


def test_a_cpu_model_never_captures(mesh2):
    m = cpu_model(mesh2, "moist")
    start = clone(m.state)
    m.step(3)
    assert (m.graph_captures, m.graph_replays, m._graph) == (0, 0, None)
    assert unequal_fields(m.state, eager(m, start, 3)) == []


def test_copy_into_stages_what_it_would_overwrite():
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    buffers = {"a": a, "b": b}
    step_graph.copy_into(buffers, {"a": b, "b": a})          # a swap
    assert a.tolist() == [10.0, 11.0, 12.0, 13.0]
    assert b.tolist() == [0.0, 1.0, 2.0, 3.0]
    step_graph.copy_into(buffers, {"a": a.flip(0), "b": b})  # its own view
    assert a.tolist() == [13.0, 12.0, 11.0, 10.0]
    assert b.tolist() == [0.0, 1.0, 2.0, 3.0]


@pytest.mark.parametrize("kind", KINDS)
def test_replayed_steps_equal_eager_steps(mesh2, faked, kind):
    m = cpu_model(mesh2, kind)
    start = clone(m.state)
    m.step(STEPS)
    assert (m.graph_captures, m.graph_replays) == (1, STEPS - 1)
    assert m.state is m._graph.state
    assert unequal_fields(m.state, eager(m, start, STEPS)) == []


def test_a_state_assigned_between_replays_is_read(mesh2, faked):
    m = cpu_model(mesh2, "moist")
    m.step(3)
    other = clone(eager(m, seeded_condensate(m.state, seed=7), 1))
    m.state = clone(other)
    m.step(1)
    assert (m.graph_captures, m.graph_replays) == (1, 3)
    assert unequal_fields(m.state, eager(m, other, 1)) == []


def test_radiation_rings_on_eager_and_replayed_steps(mesh2, faked):
    m = cpu_model(mesh2, "moist", **RAD)
    start = clone(m.state)
    m.step(STEPS)                     # rings at steps 0 (eager), 2 and 4
    assert m.radiation_calls == 3
    assert (m.graph_captures, m.graph_replays) == (1, STEPS - 1)
    ref = cpu_model(mesh2, "moist", **RAD)
    assert unequal_fields(m.state, eager(ref, start, STEPS)) == []


def test_a_new_step_or_field_captures_again(mesh2, faked):
    m = cpu_model(mesh2)
    m.step(3)
    old = m.step_fn
    m.step_fn = lambda state: old(state)
    m.step(1)                         # eager
    assert (m.graph_captures, m.graph_replays, m._graph) == (1, 2, None)
    m.step(2)                         # captures, replays
    assert (m.graph_captures, m.graph_replays) == (2, 4)
    K, C = m.state.theta_m.shape
    m.state = m.state.replace(
        scalars=torch.zeros(1, K, C, dtype=m.dtype))   # a field appears
    before = clone(m.state)
    m.step(1)                         # eager
    assert (m.graph_captures, m.graph_replays, m._graph) == (2, 4, None)
    assert unequal_fields(m.state, eager(m, before, 1)) == []
    m.step(2)
    assert (m.graph_captures, m.graph_replays) == (3, 6)


def load_reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name}", ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_each_replay_is_one_span_that_the_benchmark_reads(mesh2, faked):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    m = cpu_model(mesh2)
    m.step(2)                         # eager, then the capture
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m.step(3)
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]
    assert sum(name == "step.graph" for name, _, _ in host) == 3
    run = SimpleNamespace(trace=SimpleNamespace(host=host, steps=3))
    for name in ("graph_replay_share", "graph_replay_share.dry"):
        assert load_reader(name).read(run) == 100.0


# ---- the card --------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh3():
    return generate_mesh(levels=3, lloyd_iterations=2)


def card_model(mesh, kind="dry", **changes):
    return seeded(build_model(namelist("float32", 8, **KINDS[kind],
                                       **changes), mesh, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_replayed_steps_equal_eager_steps_on_the_card(cuda, mesh3, kind):
    m = card_model(mesh3, kind)
    start = clone(m.state)
    m.step(STEPS)
    assert (m.graph_captures, m.graph_replays) == (1, STEPS - 1)
    assert unequal_fields(m.state, eager(m, start, STEPS)) == []


@pytest.mark.gpu
def test_radiation_on_eager_and_replayed_steps_on_the_card(cuda, mesh3):
    m = card_model(mesh3, "moist", **RAD)
    ref = card_model(mesh3, "moist", **RAD)
    start = clone(m.state)
    m.step(STEPS)                     # rings at steps 0 (eager), 2 and 4
    assert m.radiation_calls == 3
    assert (m.graph_captures, m.graph_replays) == (1, STEPS - 1)
    assert unequal_fields(m.state, eager(ref, start, STEPS)) == []


@pytest.mark.gpu
def test_a_state_assigned_between_replays_is_read_on_the_card(cuda, mesh3):
    m = card_model(mesh3, "moist")
    m.step(3)
    other = clone(eager(m, seeded_condensate(m.state, seed=7), 1))
    m.state = clone(other)
    m.step(1)
    assert (m.graph_captures, m.graph_replays) == (1, 3)
    assert unequal_fields(m.state, eager(m, other, 1)) == []
