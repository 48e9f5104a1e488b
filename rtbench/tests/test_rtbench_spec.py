"""`BENCHMARK.json` against the benchmark's contract, and each name it holds
against the file the harness finds by it."""

from __future__ import annotations

import json
import re

import pytest

from rtbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.load()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == TOP_KEYS
    assert spec.BENCHMARK_FILE.stat().st_size <= 64 * 1024
    assert bench["paths"] == ["rtbench"]
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("rtbench/") and c["file"] not in files
        files.add(c["file"])
        conf = spec.read_json(spec.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"] == []
        assert conf["precision"] == "float32"


def test_workloads(bench):
    names = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert spec.traffic_file(w["traffic"]).exists()
        cell = spec.cell(bench, w["name"])
        assert cell.traffic["name"] == w["traffic"]
    assert len({w["name"] for w in bench["workloads"]}) == len(pairs)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
        module = spec.reader(m["name"])
        assert (module.NAME, module.UNIT, module.LAYER, module.SOURCE,
                module.MOVES, module.WORKLOADS) == (
            m["name"], m["unit"], m["layer"], m["source"], m["moves"],
            m["workloads"])
        layers.setdefault(m["layer"], set()).add(m["name"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        rep = [m for m in spec.metrics(bench, "end_to_end")
               if m.reported_in(w)]
        assert "setup_s" in {m.name for m in rep} and len(rep) >= 2
        assert any(m.reported_in(w) for m in spec.metrics(bench, "per_layer"))


def test_each_name_finds_its_file(bench):
    for m in spec.metrics(bench, "per_layer"):
        assert spec.metric_file(m.name).exists()
    for w in bench["workloads"]:
        assert spec.config_file(w["config"]).exists()
        assert spec.traffic_file(w["traffic"]).exists()
    assert json.loads(spec.BENCHMARK_FILE.read_text()) == bench


def test_each_plugin_is_found_by_name(bench):
    """The code a configuration or a mix names is a file of its own, found
    by that name: scene generator, reference engine, traffic generator and
    edit pattern."""
    for w in bench["workloads"]:
        cell = spec.cell(bench, w["name"])
        assert callable(spec.plugin(
            "scenes", cell.config["scene"]["generator"]).build)
        assert callable(spec.plugin(
            "references", cell.config.get("reference", "plain")).Engine)
        assert callable(spec.plugin(
            "generators", cell.traffic["generator"]).build)
        if cell.traffic.get("edits"):
            assert callable(spec.plugin(
                "edits", cell.traffic["edits"]["pattern"]).cycle)
    with pytest.raises(KeyError):
        spec.plugin("scenes", "no_such_generator")
