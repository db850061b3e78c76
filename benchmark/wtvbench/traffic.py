"""The one generator of every traffic mix.  A mix is a JSON file of
parameters under ``benchmark/traffic/``; its ``kind`` names the module
(``wtvbench/kind_<kind>.py``) that runs it, and this module makes its
inputs from the run's seed.

Every seed gets the same set of sizes: lengths are drawn once from the
mix's own ``size_seed`` (serving: one round of quantiles of the length
distribution, repeated), and the run's seed only orders them (serving:
within each round, so every prefix of the request list holds whole rounds
and the same work) and draws the content (characters, speakers, features,
audio, noise).  So two seeds ask for the same work in another order.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

# the vocabulary: pad, end of sentence, space, then CJK ideographs
SPECIAL = "PE "
FIRST_CHAR = 0x4E00


def symbols(vocab_size: int) -> str:
    return SPECIAL + "".join(chr(FIRST_CHAR + i) for i in range(vocab_size - len(SPECIAL)))


def token_ids(text: str) -> List[int]:
    """The published front end's encoding: a space first, 'E' last."""
    return [SPECIAL.index(" ")] + [ord(c) - FIRST_CHAR + len(SPECIAL) for c in text] + [
        SPECIAL.index("E")]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed))


def _torch_gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def beta_binomial_prior(n_tokens: int, n_frames: int, scaling: float, device) -> torch.Tensor:
    """[n_frames, n_tokens] f32: row i (1-based) is BetaBinomial(n_tokens - 1,
    scaling * i, scaling * (n_frames + 1 - i)) over 0..n_tokens - 1, in
    float64 by log-gamma functions on the device."""
    n = n_tokens - 1
    k = torch.arange(n_tokens, dtype=torch.float64, device=device)[None]
    i = torch.arange(1, n_frames + 1, dtype=torch.float64, device=device)[:, None]
    a, b = scaling * i, scaling * (n_frames + 1 - i)
    lg = torch.lgamma

    def lbeta(x, y):
        return lg(x) + lg(y) - lg(x + y)

    logp = (lg(torch.tensor(n + 1.0, dtype=torch.float64, device=device)) - lg(k + 1)
            - lg(n - k + 1) + lbeta(k + a, n - k + b) - lbeta(a, b))
    return torch.exp(logp).float()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

class Request(NamedTuple):
    index: int
    speaker: int
    text: str


def serve_sizes(mix: dict) -> np.ndarray:
    """One round of the mix's text lengths in characters: ``round`` evenly
    spaced quantiles of the log-uniform distribution over its range, both
    ends included."""
    lo, hi = mix["text_chars"]
    q = np.arange(mix["round"]) / (mix["round"] - 1)
    return np.rint(np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))).astype(np.int64)


def serve_requests(mix: dict, vocab_size: int, seed: int) -> List[Request]:
    rng = _rng(seed)
    one = serve_sizes(mix)
    sizes = np.concatenate([rng.permutation(one) for _ in range(mix["pool"] // len(one))])
    n_chars = vocab_size - len(SPECIAL)
    out = []
    for i, n in enumerate(sizes):
        chars = rng.integers(0, n_chars, int(n))
        text = "".join(chr(FIRST_CHAR + int(c)) for c in chars)
        out.append(Request(i, int(rng.integers(0, mix["speakers"])), text))
    return out


def speaker_data(mix: dict, n_feat: int, spk_dim: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """Each speaker's vocoder embedding [S, spk_dim] and reference clip [S,
    clip_frames, n_feat] (the Text2Vec embedding's input)."""
    g = _torch_gen(seed + 2, device)
    S = mix["speakers"]
    return {"vocoder": torch.randn((S, spk_dim), generator=g, device=device),
            "clips": torch.randn((S, mix["clip_frames"], n_feat), generator=g, device=device)
            * mix["feat_std"]}


def serve_checked(mix: dict, requests: List[Request], seed: int) -> set:
    """The requests whose answers are kept for the check: a seeded draw of
    ``1 / check_every`` of them, and every one of the longest text."""
    longest = max(len(r.text) for r in requests)
    off = int(_rng(seed + 3).integers(0, mix["check_every"]))
    return {r.index for r in requests
            if r.index % mix["check_every"] == off or len(r.text) == longest}


# ---------------------------------------------------------------------------
# training batches
# ---------------------------------------------------------------------------

def _lengths(mix: dict, key: str, offset: int, n: int) -> np.ndarray:
    lo, hi = mix[key]
    return _rng(mix["size_seed"] + offset).integers(lo, hi + 1, n)


def t2v_pool(mix: dict, cfg: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` Text2Vec training batches of ``batch`` items, padded
    to (text_pad, frame_pad), on the device: token ids, target features
    N(0, feat_std) a frame plus N(0, item_std) an utterance (the mixes take
    both from the demo corpus's features: the spread within an utterance
    and that of the utterances' means), 1-based positions, lengths and the
    beta-binomial alignment prior.  ``frames`` of each batch is its real
    frame count."""
    B, P = mix["batch"], mix["pool_batches"]
    N, T, F = mix["text_pad"], mix["frame_pad"], cfg["n_feat_dim"]
    order = _rng(seed).permutation(B * P)
    n_text = _lengths(mix, "text_range", 0, B * P)[order]
    n_frames = _lengths(mix, "frame_range", 1, B * P)[order]
    g = _torch_gen(seed + 5, device)
    pool = []
    for b in range(P):
        nt = torch.tensor(n_text[b * B:(b + 1) * B], device=device)
        nf = torch.tensor(n_frames[b * B:(b + 1) * B], device=device)
        col, row = torch.arange(N, device=device)[None], torch.arange(T, device=device)[None]
        text = torch.randint(3, cfg["vocab_size"], (B, N), generator=g, device=device)
        text = torch.where(col < nt[:, None], text, 0)
        feat = torch.randn((B, T, F), generator=g, device=device) * mix["feat_std"]
        feat = feat + torch.randn((B, 1, F), generator=g, device=device) * mix["item_std"]
        feat = feat * (row < nf[:, None]).float()[..., None]
        prior = torch.zeros((B, T, N), device=device)
        for i in range(B):
            t, n = int(nf[i]), int(nt[i])
            prior[i, :t, :n] = beta_binomial_prior(n, t, cfg["betabinom_scaling_factor"], device)
        pool.append({
            "text": text, "src_pos": torch.where(col < nt[:, None], col + 1, 0),
            "feat_target": feat, "input_lengths": nt, "output_lengths": nf,
            "feat_pos": torch.where(row < nf[:, None], row + 1, 0), "attn_prior": prior,
            "frames": int(nf.sum()),
        })
    return pool


def gan_pool(mix: dict, cfg: dict, seed: int, device, log_mel) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` vocoder training batches of whole utterances padded
    to ``frame_pad`` latent frames: N(0, 1) latents and speaker embeddings,
    N(0, audio_std) audio (zero past each item), its log-mel target (by
    ``log_mel`` over the real samples, zero past them) and the step's
    noise.  ``samples`` of each batch is its real sample count."""
    B, P, T = mix["batch"], mix["pool_batches"], mix["frame_pad"]
    up = int(np.prod(cfg["upsample_rates"]))
    order = _rng(seed).permutation(B * P)
    n_frames = _lengths(mix, "frame_range", 1, B * P)[order]
    g = _torch_gen(seed + 7, device)
    L = T * up
    n_mel = L // cfg["hop_size"]
    pool = []
    for b in range(P):
        nf = [int(x) for x in n_frames[b * B:(b + 1) * B]]
        feat = torch.randn((B, T, cfg["n_feat_dim"]), generator=g, device=device)
        audio = torch.randn((B, L, 1), generator=g, device=device) * mix["audio_std"]
        mel = torch.zeros((B, n_mel, cfg["num_mels"]), device=device)
        for i, t in enumerate(nf):
            feat[i, t:] = 0.0
            audio[i, t * up:] = 0.0
            m = log_mel(audio[i:i + 1, :t * up, 0], cfg)[0]
            mel[i, :m.shape[0]] = m
        pool.append({
            "wv_feat": feat, "audio": audio, "mel_loss": mel,
            "spk_emb": torch.randn((B, cfg["spk_dim"]), generator=g, device=device),
            "noise": torch.randn((B, cfg["noise_dim"]), generator=g, device=device),
            "samples": sum(nf) * up,
        })
    return pool
