"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and bounds, and that every name it gives has its files."""

import json
import os
import re

import pytest

from wtvbench import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return spec.load_manifest(ROOT)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"][:2] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_entries_have_just_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_uniqueness(man):
    groups = [man["configs"], man["workloads"], man["end_to_end"] + man["per_layer"]]
    for g in groups:
        names = [x["name"] for x in g]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_name_has_its_files(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in man["workloads"]:
        cell = spec.cell(w["name"], ROOT, man)
        spec.kind(cell)
        for m in cell.per_layer:
            assert callable(spec.reader(cell, m["name"]))


def test_every_cell_reports_setup_another_e2e_and_a_layer(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in man["workloads"]:
        cell = spec.cell(w["name"], ROOT, man)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
