"""Cells found by name.  ``BENCHMARK.json`` at the checkout's root lists the
cells and metrics; everything that belongs to one of them is a file of its
own under ``benchmark/``, found by its name:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  module ``wtvbench/kind_<kind>.py`` that runs it;
* a cell's limits on the numbers that decide ``correct``:
  ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(view)`` returns
  the metric from a traced run's view, or None where it finds nothing.

So a later change adds a cell, a mix or a metric by adding files and
entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def load_manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` list, or without
    one every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, root: str = ROOT, manifest: Optional[dict] = None) -> Cell:
    manifest = manifest or load_manifest(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = os.path.join(root, "benchmark")
    config = _json(os.path.join(root, configs[w["config"]]["file"]))
    mix = _json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(bench, "limits", name + ".json"))
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if reports(m, name, names)]
    return Cell(name, w, config, mix, limits, e2e, per_layer, root)


def kind(cell_: Cell):
    return importlib.import_module(f"wtvbench.kind_{cell_.traffic['kind']}")


def reader(cell_: Cell, metric: str):
    path = os.path.join(cell_.root, "benchmark", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"wtv_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
