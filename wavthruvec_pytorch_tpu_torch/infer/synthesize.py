"""End-to-end synthesis: raw text -> wav2vec latents -> 16 kHz waveform
(JAX package: infer/synthesize.py ``Synthesizer``).

Texts are padded to a text bucket and latents to ``max_frames`` (default:
the largest frame bucket); all padding is masked, so a batch of mixed-length
texts gives each item what it would get alone.  Noise for the vocoder comes
from a ``torch.Generator`` seeded with ``seed``, a different stream from the
JAX package's ``jax.random``: pass ``noise`` to reproduce a JAX run.
Text2Vec runs in f32 whatever the config's ``compute_dtype``, as the JAX
package's ``Synthesizer`` builds it (``infer/synthesize.py:158``); a
``flash_attention`` config takes the flash forward kernel in both stacks
where the gate passes (text bucket 768 and frame bucket 3072 in the
long-bucket config).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.text import TextFrontend, pad_to_bucket


def make_serving_generator(v2w_cfg: Vec2WavConfig, precision: str = "f32", device=None):
    """The Generator for a serving precision; only ``"f32"`` is ported."""
    if precision == "bf16":
        raise NotImplementedError(
            "the bf16 serving Generator (weight norm folded, bf16 weights) is not "
            "ported (ROADMAP.md, queue 1 item 3).")
    if precision != "f32":
        raise ValueError(f"unknown serving precision: {precision!r}")
    return Generator(v2w_cfg, device=device)


class Synthesizer:
    """Text2Vec + Generator on one device, built from state dicts in the
    torch reference's layout (``weights.py`` makes them from JAX variables).
    ``device`` defaults to the card and raises without one."""

    def __init__(self, t2v_cfg: Text2VecConfig, v2w_cfg: Vec2WavConfig,
                 t2v_state: Mapping[str, torch.Tensor],
                 gen_state: Mapping[str, torch.Tensor],
                 frontend: TextFrontend, device=None):
        self.device = resolve_device(device)
        self.t2v_cfg = t2v_cfg
        self.v2w_cfg = v2w_cfg
        self.t2v = Text2Vec(t2v_cfg, device=self.device)
        self.t2v.load_state_dict(t2v_state, strict=True)
        self.gen = Generator(v2w_cfg, device=self.device)
        self.gen.load_state_dict(gen_state, strict=True)
        self.frontend = frontend

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=dtype, device=self.device)

    def speaker_embedding(self, ref_feats: np.ndarray) -> np.ndarray:
        """[B, T_ref, n_feat] reference clip -> [B, n_speaker_dim] ECAPA
        embedding; pass it as ``t2v_spk_emb`` to skip ECAPA per call."""
        return self.t2v.speaker_embedding(self._tensor(ref_feats)).cpu().numpy()

    def _latents(self, texts, ref_feats, alpha, max_frames, t2v_spk_emb):
        ids, lengths = self.frontend.encode_batch(
            texts, pad_to=pad_to_bucket(
                max(len(self.frontend.text_to_sequence(t)) for t in texts),
                self.t2v_cfg.text_buckets))
        src_pos = np.where(ids != 0, np.arange(1, ids.shape[1] + 1)[None], 0)
        if max_frames is None:
            max_frames = self.t2v_cfg.frame_buckets[-1]
        spk = None if t2v_spk_emb is None else self._tensor(t2v_spk_emb)
        ref = None if spk is not None else self._tensor(ref_feats)
        out = self.t2v.infer(self._tensor(ids, torch.int64), self._tensor(src_pos, torch.int64),
                             ref, max_frames, float(alpha), spk_emb=spk)
        return out, lengths

    def text_to_latents(self, texts: Sequence[str], ref_feats: Optional[np.ndarray] = None,
                        alpha: float = 1.0, max_frames: Optional[int] = None,
                        t2v_spk_emb: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """texts + [B, T_ref, n_feat] speaker-reference feats (or
        ``t2v_spk_emb``) -> padded latents [B, max_frames, n_feat], per-item
        frame counts and a per-item finiteness flag."""
        out, lengths = self._latents(texts, ref_feats, alpha, max_frames, t2v_spk_emb)
        finite = (torch.isfinite(out["feat_output"]).flatten(1).all(dim=1)
                  & torch.isfinite(out["feat_postnet_output"]).flatten(1).all(dim=1))
        return {
            "feat_output": out["feat_output"].cpu().numpy(),
            "feat_postnet_output": out["feat_postnet_output"].cpu().numpy(),
            "total_frames": out["total_frames"].cpu().numpy(),
            "input_lengths": lengths,
            "finite_ok": finite.cpu().numpy(),
        }

    def _noise(self, B: int, seed: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((B, self.v2w_cfg.noise_dim), generator=gen, device=self.device)

    def _wav(self, latents: torch.Tensor, spk_emb, noise, seed: int, pcm16: bool):
        B = latents.shape[0]
        noise = self._noise(B, seed) if noise is None else self._tensor(noise)
        wav = self.gen(latents, self._tensor(spk_emb), noise)[..., 0]  # [B, L]
        finite = torch.isfinite(wav).all(dim=1)
        if pcm16:
            # clip, scale, truncate toward zero: the serving wire format
            wav = (wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return wav, finite

    def latents_to_wav(self, latents: np.ndarray, spk_emb: np.ndarray,
                       noise: Optional[np.ndarray] = None, seed: int = 0,
                       with_finite: bool = False, pcm16: bool = False):
        """[B, T, n_feat] latents + [B, spk_dim] speaker embedding -> [B, T*320]
        float32 waveform (int16 PCM with ``pcm16=True``); ``with_finite`` also
        returns the per-row finiteness [B] bool of the float waveform."""
        wav, finite = self._wav(self._tensor(latents), spk_emb, noise, seed, pcm16)
        wav = wav.cpu().numpy()
        return (wav, finite.cpu().numpy()) if with_finite else wav

    def synthesize(self, texts: Sequence[str], ref_feats: Optional[np.ndarray],
                   spk_emb: np.ndarray, alpha: float = 1.0,
                   max_frames: Optional[int] = None, seed: int = 0,
                   t2v_spk_emb: Optional[np.ndarray] = None,
                   noise: Optional[np.ndarray] = None,
                   pcm16: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Full pipeline -> ([B, L] waveforms, [B] sample counts).  The
        latents stay on the device between the two stages."""
        out, _ = self._latents(texts, ref_feats, alpha, max_frames, t2v_spk_emb)
        wav, _ = self._wav(out["feat_postnet_output"], spk_emb, noise, seed, pcm16)
        n_samples = out["total_frames"].cpu().numpy() * self.v2w_cfg.total_upsample
        return wav.cpu().numpy(), n_samples
