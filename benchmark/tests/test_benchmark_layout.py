"""BENCHMARK.json keeps to the benchmark's contract, and every cell,
configuration, traffic mix, entry module, limits file and per-layer metric
loads by name."""
import importlib
import json
import os
import re

import pytest

from benchmark import generate, run

BENCH = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_references():
    configs = {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load_by_name(cell):
    bench, w, entry, config, traffic = run.cell_spec(run.ROOT, cell)
    assert config["name"] == w["config"] and config["reduced"] == entry["reduced"]
    importlib.import_module("benchmark.entries." + config["entry"])
    limits = run.load_json(os.path.join(run.HERE, "limits", cell + ".json"))
    assert all(isinstance(v["limit"], float) for v in limits.values())
    gen = generate.make(traffic, 4, 2**31 + 12345)
    assert gen is not None
    reported = run.cell_metrics(bench, cell, False) + run.cell_metrics(bench, cell, True)
    assert {"setup_s", "scenario_steps_per_s"} <= {m["name"] for m in reported}
    for m in run.cell_metrics(bench, cell, True):
        assert os.path.exists(os.path.join(run.HERE, "metrics", m["name"] + ".py"))


def test_every_metric_reader_reads_nothing_from_an_empty_run():
    empty = run.Context({"control_steps": 0}, None, None, None, None)
    for m in BENCH["per_layer"]:
        assert run.read_metric(m["name"], empty) is None, m["name"]


def test_same_seed_same_traffic():
    for name in ("replay_diverse", "episode_trot"):
        spec = run.load_json(os.path.join(run.HERE, "traffic", name + ".json"))
        a, b = generate.make(spec, 8, 3_000_000_001), generate.make(spec, 8, 3_000_000_001)
        c = generate.make(spec, 8, 3_000_000_002)
        if name.startswith("replay"):
            assert (a.step(7)[0]["q"] == b.step(7)[0]["q"]).all()
            assert not (a.step(7)[0]["q"] == c.step(7)[0]["q"]).all()
        else:
            assert (a.push == b.push).all() and not (a.push == c.push).all()
