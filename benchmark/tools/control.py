"""The control of a cell's check: the reference, put in the program's place
and computed in the precision below the configuration's (TF32 for f32,
float8 e4m3 for bf16), read by the same numbers as the program, at the
cell's own size.  Its readings must fail the cell's limits; the lowest of
them is the upper reading a limit is set below.

    python3 benchmark/tools/control.py --workload CELL --seeds S1,S2,S3 [--mode tf32|fp8]
        [--fault state_unchanged|half_batch]

Prints one JSON line a seed with the readings; ``--fault`` reads a fault
of a training cell planted in the reference instead, for a number that
the control does not separate.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wtvbench import compare, spec, traffic, weights  # noqa: E402


def lower_mode(cell: spec.Cell) -> str:
    kind = cell.traffic["kind"]
    section = "vec2wav" if kind == "gan_train" else "text2vec"
    bf16 = kind != "serve" and cell.config[section].get("compute_dtype") == "bfloat16"
    return "fp8" if bf16 else "tf32"


def control_t2v(cell, seed, dev, mode, fault=None):
    from wtvbench import kind_t2v_train as k
    t = cell.config["text2vec"]
    pool = traffic.t2v_pool(cell.traffic, t, seed, dev)[:k.CHECK_STEPS]
    cand = k.reference_steps(t, seed, pool, dev, "f32" if fault else mode, fault=fault)
    whole = all(h.shape == b["attn_prior"].shape for h, b in zip(cand["hards"], pool))
    ref = k.reference_steps(t, seed, pool, dev, "f32", cand["hards"] if whole else None)
    readings = compare.train_numbers(cand, ref)
    if not whole:  # half a batch: no alignment to follow, as in a run
        readings["mas_gap"] = math.inf
    return readings


def control_gan(cell, seed, dev, mode, fault=None):
    from reference import vocoder as ref_voc
    from wtvbench import kind_gan_train as k
    v = cell.config["vec2wav"]
    pool = traffic.gan_pool(cell.traffic, v, seed, dev, ref_voc.log_mel)[:k.CHECK_STEPS]
    ref = k.reference_steps(v, cell.traffic, seed, pool, dev, "f32")
    cand = k.reference_steps(v, cell.traffic, seed, pool, dev, "f32" if fault else mode, fault)
    return compare.train_numbers(cand, ref)


def control_serve(cell, seed, dev, mode, fault=None):
    from reference import text2vec as ref_t2v
    from reference import vocoder as ref_voc
    from wtvbench import common
    from wtvbench import kind_serve as k
    mix, conf = cell.traffic, cell.config
    t, v = conf["text2vec"], conf["vec2wav"]
    t2v_state = weights.make_state(ref_t2v.param_shapes(t), seed, dev,
                                   frozen=ref_t2v.frozen_tables(t),
                                   frames_per_char=mix["frames_per_char"],
                                   duration_spread=mix["duration_spread"])
    gen_state = weights.make_state(ref_voc.generator_shapes(v), seed + 1, dev)
    common.set_output_gain(gen_state, v, mix["wav_std"], False, dev)
    spk = traffic.speaker_data(mix, t["n_feat_dim"], v["spk_dim"], seed, dev)
    requests = traffic.serve_requests(mix, t["vocab_size"], seed)
    k.calibrate(t2v_state, t, mix, requests, spk, dev)
    keep = traffic.serve_checked(mix, requests, seed)
    # the kept requests a run of the cell reaches, the longest text among them first
    reach = [r for r in requests[:mix["check_every"] * mix["checks"] * 2] if r.index in keep]
    reach.sort(key=lambda r: -len(r.text))
    rng = np.random.default_rng(seed + 4)
    pick = [reach[0]] + [reach[1:][i] for i in sorted(
        rng.choice(len(reach) - 1, mix["checks"] - 1, replace=False))]
    up = int(np.prod(v["upsample_rates"]))
    answers = []
    for r in pick:  # each padded to its own text bucket
        n_tok = len(traffic.token_ids(r.text))
        N = next((b for b in t["text_buckets"] if b >= n_tok), n_tok)
        _, out, wav = k.reference_answers([r], N, t2v_state, gen_state, spk, conf, mix, dev, mode)
        n = min(int(out["durations"][0].sum()), mix["max_frames"]) * up
        pcm = (wav[0, :n].clamp(-1, 1) * 32767.0).to(torch.int16).cpu().numpy()
        answers.append((r, n, pcm, N))
    return k.judge(answers, t2v_state, gen_state, spk, conf, mix, dev)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default=None)
    p.add_argument("--fault", default=None, choices=("state_unchanged", "half_batch"),
                   help="read a fault planted in the reference (f32) instead")
    a = p.parse_args()
    cell = spec.cell(a.workload)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    mode = a.mode or lower_mode(cell)
    fn = {"serve": control_serve, "t2v_train": control_t2v, "gan_train": control_gan}[
        cell.traffic["kind"]]
    for seed in (int(s) for s in a.seeds.split(",")):
        readings = fn(cell, seed, dev, mode, a.fault)
        fails = [n for n, val, lim in compare.checks_line(readings, cell.limits) if val > lim]
        worst = readings.pop("worst", None)
        print(json.dumps({"cell": a.workload, "seed": seed, "mode": a.fault or mode,
                          "readings": readings, "fails_limits": fails}), flush=True)
        print(json.dumps({"worst": worst}), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
