"""A cell added by new files and new entries alone is found and run: a new
traffic mix, limits and per-layer metric reader beside the existing files,
with no file of the benchmark edited."""

import json
import os
import shutil

from tiny import BENCH, MIX
from wtvbench import runner, spec


def test_cell_from_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    man = spec.load_manifest(os.path.dirname(BENCH))
    mixes, limits, metrics = root / "benchmark/traffic", root / "benchmark/limits", \
        root / "benchmark/metrics"
    with open(mixes / "t2v_train_b16_n64_t1024.json") as f:
        mix = json.load(f)
    mix.update(MIX["t2v_train_b16_n64_t1024"], batch=2)
    (mixes / "t2v_train_b2_tiny.json").write_text(json.dumps(mix))
    (limits / "t2v_new.json").write_text(json.dumps({"loss_gap": 1.0}))
    (metrics / "steps_traced.py").write_text("def read(view):\n    return view['counters']['steps']\n")
    man["workloads"].append({"name": "t2v_new", "config": "wavthruvec-aishell3",
                             "traffic": "t2v_train_b2_tiny", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "t2v_train_frames_per_s":
            m["workloads"].append("t2v_new")
    man["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                             "source": "program_counter", "layer": "Training step",
                             "moves": "t2v_train_frames_per_s", "workloads": ["t2v_new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))

    cell = spec.cell("t2v_new", str(root))
    assert cell.traffic["batch"] == 2 and cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["steps_traced"]
    import tiny
    from wtvbench import common
    cell.config["text2vec"].update(tiny.T2V)
    result = runner.run_cell(cell, 5, 0.2, True, "cpu", common.now() * 0 + __import__("time").time())
    assert result["metrics"]["steps_traced"]["value"] == mix["trace_steps"]
    assert set(result["checks"]) == {"loss_gap"}
