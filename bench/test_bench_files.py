"""Every file of the benchmark parses, names only benchmark names and
valid units, and `BENCHMARK.json` agrees with the files it names."""

import json
import re
from pathlib import Path

import pytest

from bench import harness

BENCH = Path(harness.__file__).resolve().parent
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _stems(kind, suffix):
    return sorted(p.name[:-len(suffix)] for p in (BENCH / kind).iterdir()
                  if p.name.endswith(suffix))


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads"])
def test_data_files_parse_and_are_named(kind):
    names = _stems(kind, ".json")
    assert names
    for name in names:
        assert NAME.match(name), name
        assert isinstance(harness.load_json(kind, name), dict)


@pytest.mark.parametrize("name", _stems("workloads", ".json"))
def test_cell_found_by_name(name):
    cell = harness.find_cell(name)
    assert cell.chips in (1, 4)
    assert set(cell.workload["limits"]) and all(
        v > 0 for v in cell.workload["limits"].values())
    for attr in ("E2E", "UNIT", "setup", "window", "traced", "release",
                 "check"):
        assert hasattr(cell.driver, attr), attr
    assert UNIT.match(cell.driver.UNIT)
    assert NAME.match(cell.workload["config"])
    assert NAME.match(cell.workload["traffic"])


@pytest.mark.parametrize("name", harness.metric_names())
def test_metric_reader_found_by_name(name):
    mod = harness.load_module("metrics", name)
    assert UNIT.match(mod.UNIT) and callable(mod.read)
    # a reader that finds nothing to read returns nothing
    assert mod.read(harness.Context("no_such_metric", None, {}, {})) is None


def test_benchmark_json_agrees_with_the_files():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    assert spec["command"] == ["python3", "bench/run.py"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"] + spec["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        data = harness.load_json("configs", c["name"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert c["source"] == data["source"]
        assert c["reduced"] == data["reduced"]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        assert (w["config"], w["traffic"], w["chips"]) == \
            (cell.workload["config"], cell.workload["traffic"], cell.chips)
        assert w["why"] == cell.workload["why"] and len(w["why"]) <= 200
        assert w["config"] in configs
        assert cell.driver.E2E in e2e
    readers = set(harness.metric_names())
    cells = {w["name"]: harness.find_cell(w["name"]) for w in
             spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["name"] in readers
        mod = harness.load_module("metrics", m["name"])
        assert m["unit"] == mod.UNIT
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert cells[w].driver.E2E == m["moves"] or \
                m["moves"] == "setup_s"
    for w, cell in cells.items():
        assert any(w in m["workloads"] for m in spec["per_layer"])
