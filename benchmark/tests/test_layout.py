"""Cells, configurations, drivers and metrics are found by name, and
BENCHMARK.json keeps to its contract's shape."""

import json
import re

import pytest

from benchlib import registry

BENCH = json.loads((registry.ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(entry):
    cell = registry.workload(entry["name"])
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert registry.config(cell["config"])["settings"]
    assert hasattr(registry.driver(cell["driver"]), "Driver")
    assert set(cell["limits"]) >= {"departed_steps", "feature_mismatch"}


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_found_by_name(entry):
    config = registry.config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert all(k in config["deployment"] for k in entry["reduced"])


def test_every_metric_has_its_reader_and_every_reader_a_metric():
    readers = registry.metrics()
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert sorted(names) == sorted(readers)
    assert all(callable(r.read) for r in readers.values())


def test_every_cost_file_names_its_kernels_and_op():
    for name, c in registry.costs().items():
        assert c.KERNELS and c.OP.startswith("scaloam::") and callable(c.cost), name


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/harness.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert any(w["name"] in m.get("workloads", cells) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
