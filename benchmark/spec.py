"""The benchmark's data, found by name: a cell (`workloads/<cell>.json`)
names its configuration (`configs/<config>.json`: the namelist, its source,
`reduced` and `assumed`) and its traffic (`traffic/<traffic>.json`: mesh,
levels, step, warm-up, the sampled check and the seeded inputs); a
per-layer metric is a reader `metrics/<metric>.py` with a `UNIT` and a
`read(run)` that returns a number or None. Adding any of them adds a file
and edits none. A metric of `BENCHMARK.json` that lists `workloads` is
reported in those cells alone.

A configuration may also name its own program and its own frozen
reference, each a module found by name beside the other files:

- `"program": "<name>"`, a module `programs/<name>.py` with
  `build(namelist: dict, grid: Path, device) -> model`, where `model` has
  `step(n)`, `state`, `namelist`, `mesh_arrays` and `setup_seconds`, as
  `harness.run_cell` uses them;
- `"reference": "<name>"`, a module `references/<name>.py` with
  `build(namelist: dict, grid: Path, device, dtype) -> model`, where
  `model` has `state`, `step_fn` (state -> state, one step) and `step(n)`;
  it imports nothing of the program.

`namelist` is the cell's namelist as run, with the seeded JW perturbation;
`grid` the cell's grid file. `check.fields(model.state)` of both is in the
global single-device layout. The harness keeps the rest for every
configuration: the seeded inputs, the reference's rounding for the
controls, the snapshot, the gaps and the verdict. Without the key, the
program is `mpas_tpu_torch`'s `build_model` and the reference the one under
`reference/`."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} {name!r}: a name is at most 64 letters, "
                         f"digits, '_', '.' and '-', and starts with a "
                         f"letter, a digit or '_'")
    return name


def _load(root: Path, folder: str, name: str) -> dict:
    path = root / folder / f"{check_name(name, folder)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path}")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, prefix: str):
    """The Python file at `path`, loaded as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        prefix + re.sub(r"[.-]", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _own_module(root: Path, folder: str, name):
    """The module `<folder>/<name>.py`, or None without a name."""
    if name is None:
        return None
    path = root / folder / f"{check_name(name, folder)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} module {path}")
    return _module(path, f"benchmark_{folder}_")


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    chips: int
    why: str
    limits: dict
    program: object = None       # the configuration's programs/ module
    reference: object = None     # the configuration's references/ module

    @property
    def namelist(self) -> dict:
        """The namelist as run: the configuration's, with the traffic's
        levels, top and step."""
        t = self.traffic
        return dict(self.config["namelist"], config_nvertlevels=t["levels"],
                    config_ztop=t["ztop"], config_dt=t["dt"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _load(root, "workloads", name)
    config = _load(root, "configs", w["config"])
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                config=config, traffic=_load(root, "traffic", w["traffic"]),
                chips=int(w["chips"]), why=w["why"],
                limits=dict(w.get("limits") or {}),
                program=_own_module(root, "programs", config.get("program")),
                reference=_own_module(root, "references",
                                   config.get("reference")))


def cell_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: module} of every reader under `metrics/`."""
    readers = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        name = check_name(path.stem, "metric")
        mod = _module(path, "benchmark_metric_")
        if not UNIT.match(mod.UNIT):
            raise ValueError(f"metric {name}: unit {mod.UNIT!r}")
        readers[name] = mod
    return readers


def reported_in(cell_name: str, root: Path = ROOT) -> set:
    """Names of the metrics of `BENCHMARK.json` (beside the benchmark's
    folder) that a run of the cell reports: those without `workloads` and
    those whose `workloads` name the cell. Without the file, None: every
    metric the run reads."""
    path = root.parent / "BENCHMARK.json"
    if not path.is_file():
        return None
    bench = json.loads(path.read_text())
    return {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
            if cell_name in m.get("workloads", [cell_name])}
