"""The trace reduction and the per-layer readers on a trace made by hand."""

from types import SimpleNamespace

import pytest

from benchmark import spec, work
from benchmark.trace import Trace, idle_gaps, merged

# device ops (name, start us, end us) over 2 steps, and the host's ops
DEVICE = [("k_a", 0, 10), ("acoustic_tile_kernel<float>", 5, 20),
          ("k_b", 30, 40), ("acoustic_tile_kernel<float>", 60, 70),
          ("k_a", 65, 78)]
HOST = [("aten::mul", 18, 35), ("cudaLaunchKernel", 20, 22),
        ("aten::add", 40, 50), ("aten::index_select", 50, 58)]


def trace():
    return Trace(steps=2, wall_s=100e-6, device=DEVICE, host=HOST)


def test_union_and_gaps():
    assert merged(DEVICE) == [[0, 20], [30, 40], [60, 78]]
    tr = trace()
    assert tr.busy_s == pytest.approx(48e-6)
    # gap 20-30 (middle 25: aten::mul), gap 40-60 (middle 50: index_select
    # starts there)
    gaps = dict(idle_gaps(DEVICE, HOST))
    assert gaps == pytest.approx({"aten::mul": 10e-6,
                                  "aten::index_select": 20e-6})
    b = tr.breakdown()
    assert b["device_ops"][0] == ["acoustic_tile_kernel<float>",
                                  pytest.approx(25e-6)]
    assert len(b["device_ops"]) == 3
    assert idle_gaps(DEVICE, [])[0] == ["python", pytest.approx(30e-6)]


def test_readers_on_a_hand_trace():
    sizes = dict(nCells=10, nEdges=30, nVertices=20, K=4, maxEdges=6,
                 maxEdges2=10, n_sub=2, split=1, n_scalars=0, itemsize=4,
                 index_itemsize=4, dtype="float32", dt=300.0)
    run = SimpleNamespace(trace=trace(), sizes=sizes,
                          setup_stages={"init_jw": 1.5}, window_steps=4,
                          window_s=0.2,
                          step_ms=[float(i) for i in range(1, 101)])
    got = {n: r.read(run) for n, r in spec.metric_readers().items()}
    assert got["launches_per_step"] == 2.5
    assert got["kernel_ms_per_step"] == pytest.approx(58e-3 / 2)
    assert got["device_idle_pct"] == pytest.approx(52.0)
    assert got["setup_init_s"] == 1.5
    nb, fl = work.acoustic_column(4, 10, 4)
    assert got["acoustic_column_roofline_pct"] == pytest.approx(
        100 * 2 * work.bound_seconds(nb, fl, "float32") / 25e-6)
    nb, fl = work.step(sizes)
    assert got["step_ms_p95.dry"] == pytest.approx(95.05)
    # 4 steps of 300 s in 0.2 s: 1200 s / 86400 days in 0.2 / 3600 h
    assert got["sim_days_per_hour.dry"] == pytest.approx(250.0)
    assert got["step_mfu"] == pytest.approx(
        100 * work.bound_seconds(nb, fl, "float32") / 0.05)


@pytest.mark.parametrize("metric", ["acoustic_column_roofline_pct",
                                    "sediment_roofline_pct"])
def test_roofline_is_silent_without_its_kernel(metric):
    run = SimpleNamespace(trace=Trace(1, 1e-3, [("k_a", 0, 5)], []),
                          sizes={})
    assert spec.metric_readers()[metric].read(run) is None


def test_sediment_roofline_on_a_hand_trace():
    """Two launches of Kernel 5 under their name as the profiler gives it,
    at a WSM6 step's sizes."""
    device = [("k_a", 0, 10),
              ("void (anonymous namespace)::sediment_kernel<float>(...)",
               10, 2010),
              ("sediment_kernel<float>", 3000, 5000)]
    sizes = dict(nCells=40962, K=41, nfall=53, microphysics="wsm6",
                 itemsize=4, dtype="float32")
    run = SimpleNamespace(trace=Trace(2, 1e-2, device, []), sizes=sizes)
    got = spec.metric_readers()["sediment_roofline_pct"].read(run)
    nb, fl = work.sediment(41, 40962, ("rain", "snow", "graupel"), 53, 4)
    assert fl / 67e12 > nb / 3.35e12                # bound by operations
    assert got == pytest.approx(100 * fl / 67e12 / 2e-3)
    assert 2.7 < got < 2.8
