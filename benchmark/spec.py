"""The benchmark's data, found by name: a cell (`workloads/<cell>.json`)
names its configuration (`configs/<config>.json`: the namelist, its source,
`reduced` and `assumed`) and its traffic (`traffic/<traffic>.json`: mesh,
levels, step, warm-up, the sampled check and the seeded inputs); a
per-layer metric is a reader `metrics/<metric>.py` with a `UNIT` and a
`read(run)` that returns a number or None. Adding any of them adds a file
and edits none. A metric of `BENCHMARK.json` that lists `workloads` is
reported in those cells alone."""

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

    @property
    def namelist(self) -> dict:
        """The namelist as run: the configuration's, with the traffic's
        levels, top and step."""
        t = self.traffic
        return dict(self.config["namelist"], config_nvertlevels=t["levels"],
                    config_ztop=t["ztop"], config_dt=t["dt"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    w = _load(root, "workloads", name)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                config=_load(root, "configs", w["config"]),
                traffic=_load(root, "traffic", w["traffic"]),
                chips=int(w["chips"]), why=w["why"],
                limits=dict(w.get("limits") or {}))


def cell_names(root: Path = ROOT) -> list:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def metric_readers(root: Path = ROOT) -> dict:
    """{metric name: module} of every reader under `metrics/`."""
    readers = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        name = check_name(path.stem, "metric")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + re.sub(r"[.-]", "_", name), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
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
