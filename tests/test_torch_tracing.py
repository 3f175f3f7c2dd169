"""The step's spans (mpas_tpu_torch/tracing.py, dynamics/srk3.py) on the CPU.

  - without a profiler `span()` is one shared no-op, and a step is
    bit-equal to the same step taken under the profiler;
  - under `torch.profiler.profile(activities=[CPU])`, for one dry step and
    one JW + WSM6 + PBL step: the top-level spans come in the step's order
    with the counts of its RK stages, the `moist.*` spans only in the moist
    step, and every `aten::` op of the step lies inside exactly one span,
    the outermost host event above it.

Setup: generate_mesh(levels=3, lloyd_iterations=2) (642 cells), 8 levels,
float64."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpas_tpu_torch import tracing
from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.generator import generate_mesh

KW = dict(config_nvertlevels=8, config_ztop=30000.0, dtype="float64",
          config_jw_u_perturbation=1.0)
CONFIGS = {
    "dry": KW,
    "moist": dict(KW, config_moisture=True, config_microphysics="wsm6",
                  config_pbl="ysu_lite"),
}
STAGE = ["srk3.diagnostics", "srk3.vert_imp_coefs", "srk3.dyn_tend",
         "srk3.acoustic", "srk3.recover"]
DRY_ORDER = (["srk3.setup"] + STAGE + STAGE
             + [n for n in STAGE if n != "srk3.vert_imp_coefs"]
             + ["srk3.split_finish"])
MOIST_TAIL = ["moist.transport", "moist.microphysics", "moist.pbl"]
PREFIXES = ("srk3.", "moist.")


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(levels=3, lloyd_iterations=2)


@pytest.fixture(scope="module")
def traced(mesh):
    """name -> (model, state before, state after, the step's events)."""
    out = {}

    def get(name):
        if name not in out:
            model = build_model(Namelist(**CONFIGS[name]), mesh, device="cpu")
            before = model.state
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                after = model.step_fn(before)
            out[name] = (model, before, after, prof.events())
        return out[name]

    return get


def top_spans(events):
    return sorted((e for e in events if e.name.startswith(PREFIXES)),
                  key=lambda e: e.time_range.start)


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("srk3.setup"), tracing.span("moist.pbl")
    assert a is b
    with a:
        with b:
            pass


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_is_bit_equal_under_the_profiler(traced, name):
    model, before, after, _ = traced(name)
    plain = model.step_fn(before)
    n = 0
    for f in dataclasses.fields(plain):
        x, y = getattr(plain, f.name), getattr(after, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
            n += 1
        else:
            assert x == y, f.name
    assert n > 10


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spans_come_in_the_step_order(traced, name):
    _, _, _, events = traced(name)
    order = [e.name for e in top_spans(events)]
    assert order == DRY_ORDER + (MOIST_TAIL if name == "moist" else [])
    counts = {n: order.count(n) for n in set(order)}
    assert counts["srk3.setup"] == 1 and counts["srk3.split_finish"] == 1
    assert counts["srk3.vert_imp_coefs"] == 2
    for n in ("srk3.diagnostics", "srk3.dyn_tend", "srk3.acoustic",
              "srk3.recover"):
        assert counts[n] == 3, n
    assert any(n.startswith("moist.") for n in order) == (name == "moist")


def test_split_steps_repeat_the_stages(mesh):
    """config_dynamics_split_steps = 2: the RK stages and split_finish once
    per dynamics substep, setup once."""
    model = build_model(Namelist(**KW, config_dynamics_split_steps=2), mesh,
                        device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.step_fn(model.state)
    order = [e.name for e in top_spans(prof.events())]
    assert order == ["srk3.setup"] + 2 * DRY_ORDER[1:]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_aten_op_lies_in_exactly_one_span(traced, name):
    _, _, _, events = traced(name)
    spans = top_spans(events)
    assert spans
    n = 0
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        assert chain and chain[-1].startswith(PREFIXES), (e.name, chain)
        assert sum(c.startswith(PREFIXES) for c in chain) == 1, chain
        inside = [s for s in spans if s.time_range.start <= e.time_range.start
                  and e.time_range.end <= s.time_range.end]
        assert len(inside) == 1, e.name
        n += 1
    assert n > 10 * len(spans)
