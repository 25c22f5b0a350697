"""Every cell of BENCHMARK.json resolves to its files, and the file keeps
the contract's shape."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import spec

BENCH = json.loads(spec.BENCHMARK.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = spec.load_cell(workload)
    assert spec.generator(cell.traffic).draw
    assert spec.kind(cell.traffic).run
    assert spec.reference(cell.model).param_shapes(cell.model)
    spec.model_config(cell.model)
    assert spec.builder(cell.config)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for metric in cell.per_layer:
        assert callable(spec.metric_reader(metric["name"]))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_names_units_and_links():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            moved = next(x for x in BENCH["end_to_end"]
                         if x["name"] == m["moves"])
            assert w in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"], m["layer"])
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
        cfg = spec.read_json(spec.ROOT / configs[w["config"]]["file"])
        assert sorted(cfg["reduced"]) == sorted(configs[w["config"]]
                                                ["reduced"])
        assert cfg["source"] == configs[w["config"]]["source"]
