"""Serving benchmark of the port (JAX package: infer/serve_bench.py):
end-to-end text -> wav latency and throughput across batch sizes, with the
legs at batch 1 (speaker ECAPA, Text2Vec with a cached speaker embedding
and with ECAPA, the vocoder) and the cached-embedding fast path.

    python -m wavthruvec_pytorch_tpu_torch.infer.serve_bench [--batches 1,8,16,32] \\
        [--gen_precision f32|bf16] [--t2v_config FILE] [--v2w_config FILE] \\
        [--device cpu]

``run`` returns ``{"legs_b1_ms": {...}, "batches": [rows], "device": ...}``
and prints the legs and each batch's row as JSON lines; a row has
``batch``, ``e2e_ms_cached_spk``, ``e2e_ms_full``, ``utt_per_sec_cached``,
``x_realtime_cached`` and ``device``.  Utterances are ``N_FRAMES`` latent
frames (10 s of audio).  Each time is the median over ``iters`` runs after
a warm-up, between CUDA events on the card (``rtf_bench.median_ms``).  The
JAX bench's chained dispatch and its null-program subtraction
(``overhead_ms``) belong to the TPU runtime's fetch path and are not
carried over.  ``--gen_precision bf16`` serves the bf16 Generator
(``infer.synthesize.make_serving_generator``).  Seeded random weights; the
default configs are ``Text2VecConfig()`` and ``Vec2WavConfig()``.  Without
a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.infer.rtf_bench import (
    build_models,
    device_name,
    make_inputs,
    median_ms,
)

N_FRAMES = 500  # 10 s of 16 kHz audio at x320


def run(batches: Sequence[int], iters: int = 24, gen_precision: str = "f32",
        t2v_cfg: Optional[Text2VecConfig] = None, v2w_cfg: Optional[Vec2WavConfig] = None,
        device=None, n_frames: int = N_FRAMES) -> Dict:
    device = resolve_device(device)
    t2v_cfg, v2w_cfg = t2v_cfg or Text2VecConfig(), v2w_cfg or Vec2WavConfig()
    t2v, gen = build_models(t2v_cfg, v2w_cfg, device, gen_precision)
    name = device_name(device)

    def timed(fn):
        return median_ms(torch.inference_mode()(fn), device, iters)

    x1 = make_inputs(t2v_cfg, v2w_cfg, 1, device)
    spk1 = t2v.speaker_embedding(x1["ref"])
    lat1 = t2v.infer(x1["src_seq"], x1["src_pos"], None, n_frames, 1.0, spk1)
    legs = {
        "speaker_ecapa": timed(lambda: t2v.speaker_embedding(x1["ref"])),
        "t2v_with_cached_spk": timed(lambda: t2v.infer(x1["src_seq"], x1["src_pos"], None,
                                                       n_frames, 1.0, spk1)),
        "t2v_with_ecapa": timed(lambda: t2v.infer(x1["src_seq"], x1["src_pos"], x1["ref"],
                                                  n_frames, 1.0)),
        "vocoder": timed(lambda: gen(lat1["feat_postnet_output"], x1["spk"], x1["noise"])),
    }
    print(json.dumps({"legs_b1_ms": legs, "device": name}), flush=True)

    audio_per_utt = n_frames * v2w_cfg.total_upsample / v2w_cfg.sampling_rate
    table = []
    for B in batches:
        x = make_inputs(t2v_cfg, v2w_cfg, B, device)
        spk = t2v.speaker_embedding(x["ref"])

        def e2e(spk_emb):
            ref = None if spk_emb is not None else x["ref"]
            out = t2v.infer(x["src_seq"], x["src_pos"], ref, n_frames, 1.0, spk_emb)
            return gen(out["feat_postnet_output"], x["spk"], x["noise"])

        fast, full = timed(lambda: e2e(spk)), timed(lambda: e2e(None))
        table.append({"batch": B, "e2e_ms_cached_spk": fast, "e2e_ms_full": full,
                      "utt_per_sec_cached": B / (fast / 1e3),
                      "x_realtime_cached": B * audio_per_utt / (fast / 1e3), "device": name})
        print(json.dumps(table[-1]), flush=True)
    return {"legs_b1_ms": legs, "batches": table, "device": name}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="1,8,16,32")
    p.add_argument("--gen_precision", choices=("f32", "bf16"), default="f32")
    p.add_argument("--t2v_config", default="", help="a Text2VecConfig JSON file")
    p.add_argument("--v2w_config", default="", help="a Vec2WavConfig JSON file")
    p.add_argument("--device", default=None, help="default: the card")
    a = p.parse_args(argv)
    return run([int(b) for b in a.batches.split(",")], gen_precision=a.gen_precision,
               t2v_cfg=load_config(Text2VecConfig, a.t2v_config) if a.t2v_config else None,
               v2w_cfg=load_config(Vec2WavConfig, a.v2w_config) if a.v2w_config else None,
               device=a.device)


if __name__ == "__main__":
    main()
