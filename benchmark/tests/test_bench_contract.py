"""BENCHMARK.json against the benchmark's contract: keys, names, units, the
files each entry names, which cells report which metric, and the time a
full check of 24 cells would take at `run_seconds`."""

import json
import re

import pytest

from benchmark import plugins, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_keys_and_entries(bench):
    assert set(bench) == TOP
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (spec.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word


def test_each_cell_has_its_files(bench):
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert (spec.HERE / "traffic" / f"{cell['traffic']['driver']}.py").is_file()
        assert cell["settings"]["limits"]
    for m in bench["per_layer"]:
        assert plugins.reader(m["name"]) is not None, m["name"]


def test_every_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            reported = {x["name"] for x in spec.metrics_for(cell, bench, "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)
    for w in bench["workloads"]:
        e = {x["name"] for x in spec.metrics_for(w["name"], bench, "end_to_end")}
        assert "setup_s" in e and len(e) >= 2
        assert spec.metrics_for(w["name"], bench, "per_layer")


def test_configs_used_and_layers_named_alike(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_full_check_fits(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert 1 <= bench["run_seconds"] <= 51 and total <= 43200


def test_json_is_plain():
    text = (spec.ROOT / "BENCHMARK.json").read_text()
    json.loads(text)
