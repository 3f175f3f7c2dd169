"""The readers of the program's spans on a trace made by hand: host spans
with aten ops nested in them, and the runtime calls that launch device work
inside and outside them."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import Trace

SPAN_METRICS = ("dynamics_host_ms_per_step", "moist_tail_host_ms_per_step",
                "moist_tail_launches_per_step", "dispatch_us_per_launch")
DEVICE = [("k_a", 3, 6), ("k_b", 14, 18), ("Memset (Device)", 17, 19),
          ("k_c", 27, 30), ("k_d", 54, 58), ("k_e", 62, 65),
          ("Memcpy DtoD (Device -> Device)", 64, 66), ("k_f", 82, 84)]
HOST = [
    ("srk3.setup", 0, 10),
    ("aten::zeros_like", 1, 4), ("cudaLaunchKernel", 2, 3),
    ("srk3.acoustic", 10, 40),
    ("aten::mul", 12, 20), ("cudaLaunchKernel", 13, 15),
    ("cudaMemsetAsync", 16, 17),
    ("aten::add", 25, 35), ("cudaLaunchKernelExC", 26, 28),
    # between spans: counted by no reader
    ("aten::copy_", 41, 44), ("cudaLaunchKernel", 42, 43),
    ("moist.microphysics", 50, 80),
    ("aten::clamp", 51, 60), ("cudaLaunchKernel", 52, 53),
    ("cuLaunchKernel", 61, 62), ("cudaMemcpyAsync", 63, 64),
    ("cudaStreamSynchronize", 70, 71),          # not a launch
    ("moist.pbl", 80, 90), ("cudaLaunchKernel", 80, 81),
]


def readers():
    got = spec.metric_readers()
    return {n: got[n] for n in SPAN_METRICS}


def read_all(host, device=DEVICE, steps=2):
    run = SimpleNamespace(trace=Trace(steps=steps, wall_s=100e-6,
                                      device=device, host=host))
    return {n: r.read(run) for n, r in readers().items()}


def test_known_values():
    got = read_all(HOST)
    # srk3.*: 10 + 30 us over 2 steps; moist.*: 30 + 10 us
    assert got["dynamics_host_ms_per_step"] == pytest.approx(0.020)
    assert got["moist_tail_host_ms_per_step"] == pytest.approx(0.020)
    # inside moist.*: launches at 52, 61, 63 and 80 (the pbl span's start)
    assert got["moist_tail_launches_per_step"] == 2.0
    # 80 us of spans over 4 + 4 launches inside them (not the one at 42)
    assert got["dispatch_us_per_launch"] == pytest.approx(10.0)


def test_silent_without_spans():
    no_spans = [h for h in HOST if not h[0].startswith(("srk3.", "moist."))]
    assert all(v is None for v in read_all(no_spans).values())
    # a renamed span reads as none
    renamed = [("srk3_setup" if n == "srk3.setup" else n, s, e)
               for n, s, e in no_spans + [("srk3.setup", 0, 10)]]
    assert all(v is None for v in read_all(renamed).values())


def test_dry_trace_reads_the_dynamics_alone():
    dry = [h for h in HOST if h[1] < 45]
    got = read_all(dry, steps=1)
    assert got["dynamics_host_ms_per_step"] == pytest.approx(0.040)
    assert got["moist_tail_host_ms_per_step"] is None
    assert got["moist_tail_launches_per_step"] is None
    assert got["dispatch_us_per_launch"] == pytest.approx(10.0)
    no_launch = [h for h in dry if not h[0].startswith("cu")]
    assert read_all(no_launch)["dispatch_us_per_launch"] is None


def test_units_match_the_benchmark():
    units = {n: r.UNIT for n, r in readers().items()}
    assert units == {"dynamics_host_ms_per_step": "ms",
                     "moist_tail_host_ms_per_step": "ms",
                     "moist_tail_launches_per_step": "launches/step",
                     "dispatch_us_per_launch": "us"}
