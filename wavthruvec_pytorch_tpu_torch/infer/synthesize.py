"""End-to-end synthesis: raw text -> wav2vec latents -> 16 kHz waveform
(JAX package: infer/synthesize.py ``init_import_models``,
``make_serving_generator``, ``Synthesizer`` and ``write_wav``).

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

Host and device: the inputs go to the card by ``non_blocking`` copies from
pinned memory, so a call that keeps its results on the device
(``keep_device=True``, the serving path) returns without waiting for it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.checkpoint import load_torch_state_dict
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator, fold_weight_norm
from wavthruvec_pytorch_tpu_torch.text import TextFrontend, pad_to_bucket

StateDict = Mapping[str, torch.Tensor]


def init_import_models(t2v_cfg: Text2VecConfig, v2w_cfg: Vec2WavConfig,
                       t2v_checkpoint: Optional[str] = None,
                       gen_checkpoint: Optional[str] = None,
                       folded: bool = False) -> Tuple[Dict[str, torch.Tensor],
                                                      Dict[str, torch.Tensor]]:
    """The Text2Vec and Generator state dicts for the ``synthesize`` and
    ``serve`` front ends, as CPU tensors: from the torch reference's files
    (``checkpoint_{step}.pth.tar`` with key ``model``, ``g_XXXXXXXX`` with key
    ``generator``; a directory raises, see ``checkpoint.py``), or, for a model
    without a checkpoint, seeded random weights made on the CPU (each model
    from ``torch.manual_seed(0)``, as the JAX package inits from
    ``PRNGKey(0)``), so every device serves the same ones.
    ``folded`` folds the Generator's weight norm (``fold_weight_norm``), for
    ``Generator(folded=True)``."""

    def random_state(build):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return build().state_dict()

    if t2v_checkpoint:
        t2v_state = load_torch_state_dict(t2v_checkpoint, key="model")
    else:
        t2v_state = random_state(lambda: Text2Vec(t2v_cfg, device="cpu"))
    if gen_checkpoint:
        gen_state = load_torch_state_dict(gen_checkpoint, key="generator")
    else:
        gen_state = random_state(lambda: Generator(v2w_cfg, device="cpu"))
    if folded:
        gen_state = fold_weight_norm(gen_state)
    return t2v_state, gen_state


class _F32OutputGenerator(Generator):
    """A reduced-precision serving Generator whose waveform comes out f32,
    so every consumer (``Synthesizer``, ``StreamingVocoder``, the wav
    writers) sees float32 audio whatever the compute dtype."""

    def forward(self, x: torch.Tensor, spk_emb: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        return super().forward(x, spk_emb, noise).float()


def make_serving_generator(v2w_cfg: Vec2WavConfig, gen_state: StateDict,
                           precision: str = "f32", folded: bool = False,
                           device=None) -> Tuple[Generator, Dict[str, torch.Tensor]]:
    """The serving Generator and the state dict it loads, for a precision:

    * ``"f32"``: ``Generator(folded=folded)`` and ``gen_state`` as given
      (folded by ``init_import_models(folded=True)`` when ``folded``); every
      ResBlock2 unit launches the fused kernel;
    * ``"bf16"``: weight norm folded (the reference's ``remove_weight_norm``),
      every float entry stored in bf16, the convolutions in bf16
      (``Generator(folded=True, dtype=torch.bfloat16)``), f32 audio out.  No
      unit launches the fused kernel (``models.vec2wav.fused_supported``).

    Returns ``(gen, state)`` for ``Synthesizer(..., state, frontend, gen=gen)``."""
    if precision == "f32":
        return Generator(v2w_cfg, device=device, folded=folded), dict(gen_state)
    if precision != "bf16":
        raise ValueError(f"unknown serving precision: {precision!r}")
    state = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
             for k, v in fold_weight_norm(gen_state).items()}
    gen = _F32OutputGenerator(v2w_cfg, device=device, folded=True, dtype=torch.bfloat16)
    return gen.to(torch.bfloat16), state


class Synthesizer:
    """Text2Vec + Generator on one device, built from state dicts in the
    torch reference's layout (``init_import_models`` reads them from files;
    ``weights.py`` makes them from JAX variables).  ``gen`` takes a serving
    Generator from ``make_serving_generator`` (default: the f32 one), which
    loads ``gen_state``.  ``device`` defaults to the card and raises without
    one."""

    def __init__(self, t2v_cfg: Text2VecConfig, v2w_cfg: Vec2WavConfig,
                 t2v_state: StateDict, gen_state: StateDict,
                 frontend: TextFrontend, device=None, gen: Optional[Generator] = None):
        self.device = resolve_device(device)
        self.t2v_cfg = t2v_cfg
        self.v2w_cfg = v2w_cfg
        self.t2v = Text2Vec(t2v_cfg, device=self.device)
        self.t2v.load_state_dict(t2v_state, strict=True)
        self.gen = gen if gen is not None else Generator(v2w_cfg, device=self.device)
        gen_device = next(self.gen.parameters()).device
        if gen_device.type != self.device.type:
            raise ValueError(f"the Generator lies on {gen_device}, the Synthesizer on "
                             f"{self.device}")
        self.gen.load_state_dict(gen_state, strict=True)
        self.frontend = frontend

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype)
        t = torch.from_numpy(np.array(a)).to(dtype)
        if self.device.type == "cuda":
            t = t.pin_memory()  # a copy from pageable memory may wait for the stream
        return t.to(self.device, non_blocking=True)

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
                        t2v_spk_emb: Optional[np.ndarray] = None,
                        keep_device: bool = False) -> Dict[str, np.ndarray]:
        """texts + [B, T_ref, n_feat] speaker-reference feats (or
        ``t2v_spk_emb``) -> padded latents [B, max_frames, n_feat], per-item
        frame counts and a per-item finiteness flag.

        ``keep_device=True`` leaves the latents on the device and gives, in
        place of ``total_frames`` and ``finite_ok``, one device ``meta``
        [2, B] int32: the frame counts in row 0, the finite flags in row 1,
        for one small fetch after the vocoder is dispatched."""
        out, lengths = self._latents(texts, ref_feats, alpha, max_frames, t2v_spk_emb)
        finite = (torch.isfinite(out["feat_output"]).flatten(1).all(dim=1)
                  & torch.isfinite(out["feat_postnet_output"]).flatten(1).all(dim=1))
        meta = torch.stack([out["total_frames"].to(torch.int32), finite.to(torch.int32)])
        if keep_device:
            return {
                "feat_output": out["feat_output"],
                "feat_postnet_output": out["feat_postnet_output"],
                "meta": meta,
                "input_lengths": lengths,
            }
        meta_h = meta.cpu().numpy()
        return {
            "feat_output": out["feat_output"].cpu().numpy(),
            "feat_postnet_output": out["feat_postnet_output"].cpu().numpy(),
            "total_frames": meta_h[0].astype(np.int64),
            "input_lengths": lengths,
            "finite_ok": meta_h[1].astype(bool),
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

    def latents_to_wav(self, latents, spk_emb, noise=None, seed: int = 0,
                       with_finite: bool = False, keep_device: bool = False,
                       pcm16: bool = False):
        """[B, T, n_feat] latents (host, or the device tensor of
        ``text_to_latents(keep_device=True)``) + [B, spk_dim] speaker
        embedding -> [B, T*320] float32 waveform (int16 PCM with
        ``pcm16=True``); ``with_finite`` also returns the per-row finiteness
        [B] bool of the float waveform.  ``keep_device=True`` returns the
        device tensors."""
        wav, finite = self._wav(self._tensor(latents), spk_emb, noise, seed, pcm16)
        if keep_device:
            return (wav, finite) if with_finite else wav
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


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000) -> None:
    """A mono wav file: int16 PCM as it is (the serving path quantizes on the
    device), float audio clipped to [-1, 1] and written as float32."""
    from scipy.io import wavfile

    if wav.dtype == np.int16:
        wavfile.write(path, sample_rate, wav)
    else:
        wavfile.write(path, sample_rate, np.clip(wav, -1, 1))
