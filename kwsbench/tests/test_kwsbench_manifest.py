"""BENCHMARK.json against the benchmark's contract, and the files each
entry names."""

import json
import os
import re

import pytest

from kwsbench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kwsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"][1].startswith("kwsbench/")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] \
                and "\t" not in entry[key]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = ("host_clock", "device_trace") if "bound" in metric else (
        "device_trace", "program_span", "program_counter", "host_clock")
    assert metric["source"] in allowed
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
    if metric["name"].endswith("_roofline") or "roofline" in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_unique_names():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def reports(cell: dict) -> set:
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in BENCH["end_to_end"]
            if cell["name"] in m.get("workloads", [cell["name"]])}


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_of_each_cell(metric):
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    for name in metric.get("workloads", cells):
        assert metric["moves"] in reports(cells[name]), name


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_enough(cell):
    e2e = reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer
    assert cell["chips"] == 1


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_files_found_by_name(cell):
    here = harness.HERE
    assert os.path.exists(os.path.join(here, "configs",
                                       cell["config"] + ".json"))
    traffic = harness.load_json(os.path.join(here, "traffic",
                                             cell["traffic"] + ".json"))
    assert os.path.exists(os.path.join(here, "drivers",
                                       traffic["kind"] + ".py"))
    limits = harness.load_json(os.path.join(here, "limits",
                                            cell["name"] + ".json"))
    assert limits["limits"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(metric):
    assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                       metric["name"] + ".py"))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    assert config["file"].startswith("kwsbench/configs/")
    data = harness.load_json(os.path.join(harness.ROOT, config["file"]))
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(data["changed"])
    for key in ("assumed", "precision", "peak"):
        assert data[key]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_traffic_batch_is_the_configurations(cell):
    config = harness.load_json(os.path.join(harness.HERE, "configs",
                                            cell["config"] + ".json"))
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic",
                                             cell["traffic"] + ".json"))
    assert traffic["batch_size"] == \
        config["dataset_conf"]["batch_conf"]["batch_size"]
