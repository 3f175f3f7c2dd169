"""The cell `moist_120km_rad30m`: its configuration brings its own frozen
reference (the frozen dycore with the plain CAM-slot radiation on MPAS's
alarm) and no program, so the harness runs `build_model`, the normal path;
the reference matches the port through the harness at a tiny size,
refuses a radiation it does not carry, and is not matched by the program
with its radiation off, also as `readings.py` reads the limits; the
radiation's two readers on a trace made by hand."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, harness, inputs, readings, spec
from benchmark.trace import Trace
from conftest import tiny

CELL = "moist_120km_rad30m"
REL = 1e-10
RADIATION_KEYS = ("config_radt_lw_scheme", "config_radt_sw_scheme",
                  "config_radtlw_interval", "config_radtsw_interval")


def float64_cell(levels=6):
    cell = tiny(spec.load_cell(CELL), levels=levels, check_steps=(7, 7))
    cell.config = dict(cell.config,
                       namelist=dict(cell.config["namelist"], dtype="float64"))
    return cell


def test_the_cell_loads_its_reference():
    cell = spec.load_cell(CELL)
    assert cell.program is None and "program" not in cell.config
    assert cell.reference.__file__.endswith(
        "references/jw_moist_wsm6_camrad.py")
    assert cell.traffic["trace_steps"] * cell.traffic["dt"] == 1800.0
    nl = cell.namelist
    assert (nl["config_radt_lw_scheme"], nl["config_radt_sw_scheme"]) == (
        "cam_lw", "cam_sw")
    assert nl["config_radtlw_interval"] == nl["config_radtsw_interval"] \
        == 1800.0
    base = spec.load_cell("moist_120km")
    assert {k: v for k, v in nl.items() if k not in RADIATION_KEYS} \
        == base.namelist
    assert cell.limits.keys() == base.limits.keys()


def test_the_reference_matches_the_port(grid_dir):
    """7 float64 steps of 300 s (the radiation at steps 0 and 6) from the
    seeded inputs, through the harness's program and reference runs."""
    cell = float64_cell()
    draws = inputs.draw(2 ** 33 + 41, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    device = torch.device("cpu")
    model = harness.build_program(cell, draws, grid, device)
    assert model.dtype == torch.float64 and model.radiation_interval == 1800.0
    start = check.to_host(check.fields(model.state))
    model.step(7)
    assert model.radiation_calls == 2
    port = check.to_host(check.fields(model.state))
    ref0, ref = check.reference_run(cell, draws, grid, 7, device)
    assert sorted(port) == sorted(ref) == sorted(check.FIELDS)
    assert ref["scalars"][1:].max() > 0 and ref["rainnc"].max() > 0
    for k in ref:
        np.testing.assert_array_equal(start[k], ref0[k])
        assert np.abs(port[k] - ref[k]).max() <= REL * np.abs(ref[k]).max(), k
    assert max(check.gaps(port, ref, ref0).values()) <= 1e-8


def test_the_program_without_radiation_reads_apart(grid_dir):
    """The same program with its radiation off, against this cell's
    reference: the heating the reference applies shows in theta_m, far
    above the float64 agreement of the radiating program."""
    cell = float64_cell()
    draws = inputs.draw(2 ** 33 + 41, cell.traffic)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    device = torch.device("cpu")
    off = tiny(spec.load_cell("moist_120km"), levels=6)
    off.config = dict(off.config,
                      namelist=dict(off.config["namelist"], dtype="float64"))
    model = harness.build_program(off, draws, grid, device)
    model.step(7)
    port = check.to_host(check.fields(model.state))
    ref0, ref = check.reference_run(cell, draws, grid, 7, device)
    assert check.gaps(port, ref, ref0)["theta_m"] > 1e-4


def test_the_readings_of_the_limits(grid_dir):
    """benchmark/readings.py on one reference run a seed: the cell's own
    program reads the float64 agreement, the program of `jw_moist_wsm6`
    (the radiation off) reads apart in theta_m."""
    cell = float64_cell()
    got = readings.readings(cell, 2 ** 33 + 41, torch.device("cpu"),
                            ("sound", "jw_moist_wsm6"), grid_dir)
    assert sorted(got) == ["jw_moist_wsm6", "sound"]
    assert sorted(got["sound"]) == sorted(cell.limits)
    assert got["sound"]["nonfinite"] == 0
    assert max(got["sound"].values()) <= 1e-8
    assert got["jw_moist_wsm6"]["theta_m"] > 1e-4


@pytest.mark.parametrize("changes,key", [
    (dict(config_radt_lw_scheme="off"), "config_radt_lw_scheme"),
    (dict(config_radt_sw_scheme="rrtmg_sw"), "config_radt_sw_scheme"),
    (dict(config_radtsw_interval=3600.0), "config_radtlw_interval"),
])
def test_the_reference_refuses_what_it_does_not_carry(changes, key,
                                                       grid_dir):
    cell = float64_cell(levels=4)
    namelist = dict(cell.namelist, **changes)
    with pytest.raises(ValueError, match=key):
        cell.reference.build(namelist, inputs.grid_file(2, grid_dir),
                             torch.device("cpu"), torch.float64)


# two radiation calls in the traced steps: the model's columns, the
# driver's columns, SW, LW and the coupling of each, between step spans
HOST = [
    ("srk3.setup", 0, 10), ("cudaLaunchKernel", 2, 3),
    ("rad.columns", 10, 14), ("cudaLaunchKernel", 11, 12),
    ("rad.columns", 15, 20), ("cudaLaunchKernel", 16, 17),
    ("cudaMemsetAsync", 18, 19),
    ("rad.sw", 20, 40), ("aten::mul", 21, 30), ("cudaLaunchKernel", 22, 23),
    ("cudaLaunchKernelExC", 31, 32), ("cudaStreamSynchronize", 33, 34),
    ("rad.lw", 40, 55), ("cudaLaunchKernel", 41, 42),
    ("rad.couple", 55, 58), ("cudaLaunchKernel", 56, 57),
    ("python_glue", 58, 59), ("cudaLaunchKernel", 58, 59),   # outside
    ("srk3.diagnostics", 60, 70), ("cudaLaunchKernel", 61, 62),
    ("rad.columns", 100, 102), ("rad.columns", 102, 104),
    ("rad.sw", 104, 110), ("cudaLaunchKernel", 105, 106),
    ("rad.lw", 110, 115), ("rad.couple", 115, 116),
]


def read(host, steps=6):
    readers = spec.metric_readers()
    run = SimpleNamespace(trace=Trace(steps=steps, wall_s=1e-3,
                                      device=[("k", 0, 1)], host=host))
    return {n: readers[n].read(run) for n in
            ("radiation_host_ms_per_call", "radiation_launches_per_call")}


def test_the_readers_on_a_made_trace():
    got = read(HOST)
    # spans: 4 + 5 + 20 + 15 + 3 and 2 + 2 + 6 + 5 + 1 us over two calls
    assert got["radiation_host_ms_per_call"] == pytest.approx(0.0315)
    # launches inside rad.*: 11, 16, 18, 22, 31, 41, 56 and 105 (the sync
    # and the launch outside the spans do not count)
    assert got["radiation_launches_per_call"] == 4.0


def test_the_readers_are_silent_without_radiation():
    no_rad = [h for h in HOST if not h[0].startswith("rad.")]
    assert read(no_rad) == {"radiation_host_ms_per_call": None,
                            "radiation_launches_per_call": None}
    renamed = [("rad_sw" if n == "rad.sw" else n, s, e) for n, s, e in HOST]
    assert read(renamed) == {"radiation_host_ms_per_call": None,
                             "radiation_launches_per_call": None}
