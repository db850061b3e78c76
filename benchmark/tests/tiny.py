"""Tiny configurations and mixes of the benchmark's cells, for the CPU tests."""

from __future__ import annotations

import copy
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

T2V = dict(n_feat_dim=16, spk_channel=16, n_speaker_dim=8, encoder_dim=16, decoder_dim=16,
           encoder_conv1d_filter_size=32, decoder_conv1d_filter_size=32, encoder_n_layer=1,
           decoder_n_layer=1, vocab_size=40, max_seq_len=128, duration_predictor_filter_size=8,
           text_buckets=[8, 16], frame_buckets=[64])
V2W = dict(n_feat_dim=16, spk_dim=8, noise_dim=8, upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
           upsample_initial_channel=16, resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 2]],
           periods=[2, 3], n_fft=256, win_size=256, hop_size=64, num_mels=16, num_wv_feat=16)
MIX = {
    "serve_closed_c16": dict(clients=3, max_batch=2, max_frames=64, text_chars=[2, 6], pool=64, round=8, probe_texts=16,
                             speakers=4, clip_frames=8, frames_per_char=3.0, duration_spread=0.8,
                             check_every=2, checks=4, check_block=2, trace_seconds=1),
    "t2v_train_b16_n64_t1024": dict(batch=4, text_pad=8, text_range=[3, 8], frame_pad=32,
                                     frame_range=[16, 32], warm_steps=3, trace_steps=1),
    "gan_train_b2_t256": dict(batch=2, frame_pad=160, frame_range=[130, 160], warm_steps=3,
                              trace_steps=1),
}


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def config(name: str = "wavthruvec-aishell3", **t2v) -> dict:
    c = copy.deepcopy(_json("configs", name + ".json"))
    c["text2vec"].update(T2V, **t2v)
    c["vec2wav"].update(V2W)
    return c


def mix(name: str) -> dict:
    m = _json("traffic", name + ".json")
    m.update(MIX[name])
    return m


def cell(workload: str, mix_name: str, limits: dict, config_name: str = "wavthruvec-aishell3",
         **t2v):
    import sys
    for p in (BENCH, os.path.dirname(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from wtvbench import spec

    man = _json("..", "BENCHMARK.json")
    w = next(x for x in man["workloads"] if x["name"] == workload)
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in man["per_layer"] if workload in m.get("workloads", [])]
    return spec.Cell(workload, w, config(config_name, **t2v), mix(mix_name), limits, e2e,
                     per_layer, os.path.dirname(BENCH))
