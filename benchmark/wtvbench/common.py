"""What every kind of cell shares: the run's arguments, the program's
configuration objects, device bookkeeping and the Generator's output gain."""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import torch

from reference import vocoder as ref_voc
from reference.ops import Ops, precision_flags


@dataclasses.dataclass
class RunArgs:
    cell: "object"          # spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float          # the process's start, on time.time()'s clock
    fault: Optional[str] = None  # tests only: a fault planted in the timed path


def program_configs(config: dict):
    """The program's ``Text2VecConfig`` and ``Vec2WavConfig`` from a
    configuration file's two sections (lists become tuples)."""
    from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig

    def build(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k in names:
                kw[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v) \
                    if isinstance(v, list) else v
        return cls(**kw)

    return build(Text2VecConfig, config["text2vec"]), build(Vec2WavConfig, config["vec2wav"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def since(t_start: float) -> float:
    return time.time() - t_start


now = time.perf_counter


@torch.no_grad()
def set_duration_bias(t2v_state: dict, cfg: dict, texts, speaker_emb: torch.Tensor,
                      frames_per_char: float, device) -> None:
    """Shift the duration predictor's output bias so that its mean output
    over ``texts``, each with its row of ``speaker_emb``, is
    ``frames_per_char``: with random weights the mean would move with the
    seed, and the audio a request asks for with it.  One shift is exact
    where the output lies in the ReLU's linear range, where
    ``weights.make_state`` puts it."""
    from reference import text2vec as ref_t2v
    from wtvbench import traffic

    ids = [traffic.token_ids(t) for t in texts]
    N = max(len(i) for i in ids)
    ids_t = torch.zeros((len(ids), N), dtype=torch.long, device=device)
    for j, i in enumerate(ids):
        ids_t[j, :len(i)] = torch.tensor(i, device=device)
    pos = torch.where(ids_t != 0, torch.arange(1, N + 1, device=device)[None], 0)
    with precision_flags("f32"):
        enc = ref_t2v.encoder(t2v_state, ids_t, pos, speaker_emb, cfg, Ops())
        dp = ref_t2v.duration_predictor(t2v_state, enc, Ops())
    mean = float(dp[ids_t != 0].mean())
    t2v_state["length_regulator.duration_predictor.linear_layer.linear_layer.bias"] += (
        frames_per_char - mean)


@torch.no_grad()
def set_output_gain(gen_state: dict, cfg: dict, wav_std: float, train: bool, device) -> None:
    """Scale ``conv_post``'s gain so that, on a probe of N(0, 1) latents,
    the waveform before the tanh has a standard deviation of ``wav_std``
    (random weights would give audio far louder or quieter than speech).
    For eval mode (serving) the Conditional BatchNorms' running statistics
    are first set to the probe's batch statistics, as a trained Generator's
    are to its data's (the port's ``recalibrate-bn``): drawn at random they
    let the activations grow by orders of magnitude from stage to stage,
    and the waveform then saturates."""
    g = torch.Generator(device=device).manual_seed(1)
    lat = torch.randn((4, 64, cfg["n_feat_dim"]), generator=g, device=device)
    spk = torch.randn((4, cfg["spk_dim"]), generator=g, device=device)
    noise = torch.randn((4, cfg["noise_dim"]), generator=g, device=device)
    with precision_flags("f32"):
        if not train:
            stats: dict = {}
            ref_voc.generator(gen_state, lat, spk, noise, cfg, True, Ops("f32"), {}, record=stats)
            for pre, (mean, var) in stats.items():
                gen_state[pre + "running_mean"].copy_(mean)
                gen_state[pre + "running_var"].copy_(var)
        raw = ref_voc.generator(gen_state, lat, spk, noise, cfg, train, Ops("f32"), {}, raw=True)
    raw = raw - gen_state["conv_post.bias"]
    gen_state["conv_post.weight_g"].mul_(wav_std / float(raw.std()))
