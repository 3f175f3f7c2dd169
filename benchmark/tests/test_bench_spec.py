"""The benchmark's data: every file parses, every name and unit keeps to
the allowed characters, BENCHMARK.json agrees with the files, and a new
configuration, traffic, cell or per-layer metric is found from its files
alone."""

import json
import shutil
import time

import pytest
import torch

from benchmark import harness, inputs, spec
from conftest import ROOT, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads():
    names = spec.cell_names()
    assert names
    for name in names:
        cell = spec.load_cell(name)
        assert cell.chips in (1, 4)
        assert 1 <= len(cell.why) <= 200 and "\n" not in cell.why
        for key in ("grid_level", "levels", "dt", "warmup_steps",
                    "check_steps", "trace_steps", "jw_u_perturbation"):
            assert key in cell.traffic, (name, key)
        assert "namelist" in cell.config


def test_benchmark_json_matches_the_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert sorted(cells) == spec.cell_names()
    for name, w in cells.items():
        cell = spec.load_cell(name)
        assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
            cell.config_name, cell.traffic_name, cell.chips, cell.why)
    configs = {c["name"]: c for c in BENCH["configs"]}
    for name, c in configs.items():
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == name and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    readers = spec.metric_readers()
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    assert sorted(per_layer) == sorted(readers)
    for name, m in per_layer.items():
        assert m["unit"] == readers[name].UNIT
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert e2e == {"sim_days_per_hour", "step_ms_p95", "peak_mem_gib",
                   "setup_s"}
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    # a metric listed for some cells names known cells, and a per-layer
    # metric's cells all report the end-to-end metric it moves
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells), m
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert m["moves"] in spec.reported_in(cell), (m, cell)
    for cell in cells:
        got = spec.reported_in(cell)
        assert "setup_s" in got and len(got & e2e) >= 2, cell
        assert got - e2e, cell


def test_names_and_units():
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    configs = [c["name"] for c in BENCH["configs"]]
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    for group in (metrics, cells, configs, pairs):
        assert len(set(group)) == len(group), group
    for n in metrics + cells + configs + [t for _, t in pairs]:
        spec.check_name(n, "name")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        for key in c["reduced"]:
            spec.check_name(key, "reduced key")
    for bad in ("a b", "a/b", "a,b", "-a", "", "x" * 65, "\u03bcs"):
        with pytest.raises(ValueError):
            spec.check_name(bad, "name")


def test_bounds_keep_to_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert 1 <= BENCH["run_seconds"] <= 51


def test_new_entries_need_only_new_files(tmp_path):
    """A configuration, a traffic, a cell and a per-layer metric added as
    files in a copy of the benchmark's data are found by name."""
    for folder in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(spec.ROOT / folder, tmp_path / folder)
    config = json.loads((tmp_path / "configs" / "jw_dry.json").read_text())
    config["name"] = "jw_dummy"
    config["namelist"]["config_smdiv"] = 0.05
    (tmp_path / "configs" / "jw_dummy.json").write_text(json.dumps(config))
    traffic = json.loads(
        (tmp_path / "traffic" / "x1.40962_L41_dt300.json").read_text())
    traffic["dt"] = 600.0
    (tmp_path / "traffic" / "x1.40962_L41_dt600.json").write_text(
        json.dumps(traffic))
    (tmp_path / "workloads" / "dummy_120km.json").write_text(json.dumps({
        "config": "jw_dummy", "traffic": "x1.40962_L41_dt600", "chips": 1,
        "why": "a dummy cell", "limits": {"u": 0.5}}))
    (tmp_path / "metrics" / "dummy_metric.py").write_text(
        'UNIT = "launches/step"\n\n\ndef read(run):\n    return 1.0\n')

    assert "dummy_120km" in spec.cell_names(tmp_path)
    cell = spec.load_cell("dummy_120km", tmp_path)
    assert cell.namelist["config_smdiv"] == 0.05
    assert cell.namelist["config_dt"] == 600.0
    assert cell.limits == {"u": 0.5}
    readers = spec.metric_readers(tmp_path)
    assert readers["dummy_metric"].read(None) == 1.0
    assert set(spec.metric_readers()) < set(readers)
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no_such_cell", tmp_path)


PROGRAM = """from mpas_tpu_torch.config import Namelist
from mpas_tpu_torch.dynamics.model import build_model
from mpas_tpu_torch.mesh.loader import load_mesh

CALLS = []


def build(namelist, grid, device):
    CALLS.append(grid)
    return build_model(Namelist(**namelist), load_mesh(str(grid)),
                       device=device)
"""

REFERENCE = """from benchmark.reference.config import Namelist
from benchmark.reference.dynamics.model import build_model
from benchmark.reference.mesh.loader import load_mesh

CALLS = []


def build(namelist, grid, device, dtype):
    CALLS.append(grid)
    model = build_model(Namelist(**namelist), load_mesh(str(grid)), device,
                        dtype)
    step = model.step
    model.step = lambda n: step(n - SHORT)
    return model
"""


@pytest.mark.parametrize("case", ["sound", "reference_one_step_short",
                                  "no_program_file", "no_reference_file"])
def test_a_configuration_brings_its_own_modules(case, tmp_path, grid_dir):
    """A configuration that names its own program and reference modules,
    added as new files in a copy of the benchmark's data, runs through the
    harness: correct where both do the work, not correct where the
    reference leaves out a step, and refused when a named module has no
    file."""
    for folder in ("configs", "traffic", "workloads"):
        shutil.copytree(spec.ROOT / folder, tmp_path / folder)
    config = json.loads((tmp_path / "configs" / "jw_dry.json").read_text())
    config.update(name="jw_own", program="jw_own_program",
                  reference="jw_own_reference")
    (tmp_path / "configs" / "jw_own.json").write_text(json.dumps(config))
    workload = json.loads(
        (tmp_path / "workloads" / "dry_120km.json").read_text())
    workload["config"] = "jw_own"
    (tmp_path / "workloads" / "own_120km.json").write_text(
        json.dumps(workload))
    (tmp_path / "programs").mkdir()
    (tmp_path / "references").mkdir()
    short = int(case == "reference_one_step_short")
    if case != "no_program_file":
        (tmp_path / "programs" / "jw_own_program.py").write_text(PROGRAM)
    if case != "no_reference_file":
        (tmp_path / "references" / "jw_own_reference.py").write_text(
            REFERENCE.replace("SHORT", str(short)))
    if case.startswith("no_"):
        with pytest.raises(FileNotFoundError, match=case.split("_")[1]):
            spec.load_cell("own_120km", tmp_path)
        return

    cell = tiny(spec.load_cell("own_120km", tmp_path))
    assert cell.program.__file__.startswith(str(tmp_path / "programs"))
    assert cell.reference.__file__.startswith(str(tmp_path / "references"))
    res = harness.run_cell(cell, 2 ** 31 + 9, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), 0.0, grid_dir=grid_dir,
                           log=lambda msg: None)
    grid = inputs.grid_file(cell.traffic["grid_level"], grid_dir)
    assert cell.program.CALLS == [grid]
    assert cell.reference.CALLS == [grid]
    assert res["attempted"] >= 1
    assert {"u", "w", "theta_m", "rho_zz", "nonfinite"} <= set(res["checks"])
    if short:
        assert not res["correct"] and res["failed"] >= 1, res["checks"]
    else:
        assert res["correct"] and res["failed"] == 0, res["checks"]
