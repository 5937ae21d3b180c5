"""Every file BENCHMARK.json names loads, and its names and units keep to
the benchmark's character sets."""

import json
import re

import pytest

from portbench.spec import ROOT, load_cell, load_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_units_and_readers(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(load_reader(ROOT, metric["name"]))
    if metric in BENCH["per_layer"]:    # a reader is bound to its cells
        assert metric["workloads"]
    for w in metric.get("workloads", []):
        assert w in {c["name"] for c in BENCH["workloads"]}
    if "moves" in metric:
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for w in metric["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert NAME.match(config["name"])
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert all(NAME.match(k) for k in config["reduced"])
    assert "assumed" in data and data["report_config"]["dtype"] == "float32"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    resolved = load_cell(cell["name"])
    assert resolved.chips == cell["chips"]
    assert {m.name for m in resolved.end_to_end} >= {"setup_s"}
    assert len(resolved.end_to_end) >= 2 and resolved.per_layer
    assert resolved.traffic["loop"] in ("closed_loop", "corpus_stream",
                                        "device_batches", "mesh_corpus")


def test_limits_name_every_compared_number():
    from portbench import check
    assert set(check.limits()) == set(check.unreadable())
    assert all(v >= 0 for v in check.limits().values())
