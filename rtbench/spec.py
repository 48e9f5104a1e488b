"""`BENCHMARK.json` and the files its names point at.

A configuration `<name>` is `rtbench/configs/<name>.json`, a traffic mix
`rtbench/traffic/<name>.json` and a per-layer metric `rtbench/metrics/
<name>.py`. The code a configuration or a mix names is a plug-in found the
same way, by name (`plugin`): a scene generator `rtbench/scenes/
<generator>.py`, a traffic generator `rtbench/generators/<generator>.py`,
an edit pattern `rtbench/edits/<pattern>.py` and a reference engine
`rtbench/references/<reference>.py`. A later change adds a cell, a mix, a
metric or a plug-in as new files and new entries, and edits nothing here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
BENCHMARK_FILE = ROOT / "BENCHMARK.json"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of `workloads`: its configuration and traffic, read."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict


@dataclasses.dataclass(frozen=True)
class Metric:
    """One metric of `end_to_end` or `per_layer`."""

    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    layer: Optional[str] = None
    moves: Optional[str] = None

    def reported_in(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(path: Path = BENCHMARK_FILE) -> dict:
    return read_json(path)


def config_file(name: str) -> Path:
    return PACKAGE / "configs" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return PACKAGE / "traffic" / f"{name}.json"


def metric_file(name: str) -> Path:
    return PACKAGE / "metrics" / f"{name}.py"


def cell(bench: dict, workload: str) -> Cell:
    """The cell `workload` of `bench` with its two files read. Raises
    KeyError for a name `bench` does not hold."""
    entry = {w["name"]: w for w in bench["workloads"]}[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    return Cell(name=workload, config_name=entry["config"],
                traffic_name=entry["traffic"], chips=int(entry["chips"]),
                config=read_json(ROOT / conf["file"]),
                traffic=read_json(traffic_file(entry["traffic"])))


def metrics(bench: dict, kind: str) -> List[Metric]:
    """The `end_to_end` or `per_layer` metrics of `bench`."""
    return [Metric(name=m["name"], unit=m["unit"], better=m["better"],
                   source=m["source"], workloads=m.get("workloads"),
                   layer=m.get("layer"), moves=m.get("moves"))
            for m in bench[kind]]


_PLUGINS: Dict[Path, ModuleType] = {}


def plugin(kind: str, name: str) -> ModuleType:
    """The module `rtbench/<kind>/<name>.py`, loaded by path (a name may
    hold dots) once a process. Raises KeyError where there is none."""
    path = PACKAGE / kind / f"{name}.py"
    if path not in _PLUGINS:
        if not path.is_file():
            raise KeyError(f"no {kind} plug-in {name!r} ({path})")
        tag = f"rtbench_{kind}_{name}".replace(".", "_").replace("-", "_")
        spec = importlib.util.spec_from_file_location(tag, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _PLUGINS[path] = module
    return _PLUGINS[path]


def reader(name: str) -> ModuleType:
    """The reader module of per-layer metric `name` (`metrics/<name>.py`).
    It defines `read(stretch)`, which returns the metric's value, or None
    where there is nothing to read."""
    return plugin("metrics", name)


def readers(bench: dict, workload: str) -> Dict[str, ModuleType]:
    """The reader of every per-layer metric that cell `workload` reports."""
    return {m.name: reader(m.name) for m in metrics(bench, "per_layer")
            if m.reported_in(workload)}
