"""`graph_replay_share` and `graph_replay_share.dry` on traces made by
hand: 100 with one `step.graph` span a traced step, its share where some
steps ran eagerly, and nothing where the trace holds no such span (a
program that steps eagerly, or a renamed span)."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import Trace

NAMES = ("graph_replay_share", "graph_replay_share.dry")

# three traced steps, each one replay between host work of the harness
REPLAYS = [
    ("cudaEventRecord", 0, 1), ("step.graph", 2, 9),
    ("cudaGraphLaunch", 3, 8), ("cudaEventRecord", 9, 10),
    ("step.graph", 12, 19), ("cudaGraphLaunch", 13, 18),
    ("step.graph", 22, 29), ("cudaGraphLaunch", 23, 28),
]


def read(host, steps=3):
    readers = spec.metric_readers()
    run = SimpleNamespace(trace=Trace(steps=steps, wall_s=1e-3,
                                      device=[("k", 0, 1)], host=host))
    return {n: readers[n].read(run) for n in NAMES}


def test_one_replay_a_step_reads_100():
    assert read(REPLAYS) == {n: 100.0 for n in NAMES}


def test_eager_steps_lower_the_share():
    assert read(REPLAYS, steps=6) == {n: pytest.approx(50.0) for n in NAMES}


@pytest.mark.parametrize("host", [
    [h for h in REPLAYS if h[0] != "step.graph"],
    [("srk3.setup", 0, 5), ("moist.pbl", 5, 9), ("cudaLaunchKernel", 6, 7)],
    [("step_graph" if n == "step.graph" else n, s, e) for n, s, e in REPLAYS],
])
def test_no_replay_span_reads_nothing(host):
    assert read(host) == {n: None for n in NAMES}
