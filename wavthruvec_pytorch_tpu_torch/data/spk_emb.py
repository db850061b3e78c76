"""Per-speaker embeddings for the Vec2Wav conditioning (JAX package:
data/spk_emb.py; reference: vec2wav/pre_spk_emb.py:1-33, which embeds the
concatenation of a speaker's first 50 wavs with SpeechBrain's pretrained
ECAPA and saves ``spk_emb/{spk}.pth``).

Two embedders, each on one device (the card unless ``device`` says
otherwise), each returning a [n_speaker_dim] float32 vector:

* ``SpeakerEmbedder``: the repo's ECAPA (``models/ecapa.py``) on raw wav
  (``input_wav=True``, 80 mel bands), the concatenation zero-padded to a
  power-of-two bucket of at least one second, as the JAX package pads it;
* ``SpeechBrainEmbedder``: SpeechBrain's ECAPA (``models/
  ecapa_speechbrain.py``) with its fbank and sentence normalisation, the
  source the reference really used.  Zero padding would move the fbank's
  statistics, so the concatenation is cut down to whole seconds
  (``exact=True`` keeps every sample).

Weights: a state dict in the port's layout (``weights.py`` carries JAX
variables into one), SpeechBrain's ``embedding_model.ckpt`` read from a
local path, or seeded random ones (``torch.manual_seed(0)``) for pipeline
runs.  ``precompute_speaker_embeddings`` writes ``{out_dir}/{spk}.npy``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_wav
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.ecapa import N_MELS, ECAPA_TDNN
from wavthruvec_pytorch_tpu_torch.models.ecapa_speechbrain import (
    ECAPA_TDNN_SB,
    load_speechbrain_state_dict,
    sb_encode,
)

SAMPLE_RATE = 16000


def _seeded(build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build()


class SpeakerEmbedder:
    """The repo's ECAPA on raw waveforms, in eval mode."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None, C: int = 1024,
                 n_speaker_dim: int = 192, max_samples: int = SAMPLE_RATE * 60, device=None):
        self.device = resolve_device(device)
        self.max_samples = max_samples
        self.model = _seeded(lambda: ECAPA_TDNN(C, N_MELS, n_speaker_dim, input_wav=True,
                                                device="cpu"))
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model = self.model.to(self.device).eval()

    def padded(self, wavs: Sequence[np.ndarray]) -> np.ndarray:
        """The concatenation, cut at ``max_samples`` and zero-padded to a
        power of two of at least ``SAMPLE_RATE`` samples."""
        cat = np.concatenate(wavs)[: self.max_samples].astype(np.float32)
        bucket = 1 << int(np.ceil(np.log2(max(len(cat), SAMPLE_RATE))))
        return np.pad(cat, (0, bucket - len(cat)))

    @torch.inference_mode()
    def embed_concat(self, wavs: Sequence[np.ndarray]) -> np.ndarray:
        """A speaker's utterances -> [n_speaker_dim]."""
        x = torch.as_tensor(self.padded(wavs)[None], device=self.device)
        return self.model(x)[0].float().cpu().numpy()


class SpeechBrainEmbedder:
    """SpeechBrain's ECAPA (``spkrec-ecapa-voxceleb``) with its fbank, in
    eval mode.  ``torch_ckpt``: the bundle's ``embedding_model.ckpt`` (a
    local file); ``state_dict``: weights in the port's layout."""

    def __init__(self, torch_ckpt: Optional[str] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 max_samples: int = SAMPLE_RATE * 60, device=None):
        self.device = resolve_device(device)
        self.max_samples = max_samples
        self.model = _seeded(lambda: ECAPA_TDNN_SB(device="cpu"))
        if torch_ckpt is not None:
            state_dict = load_speechbrain_state_dict(
                torch.load(torch_ckpt, map_location="cpu", weights_only=True))
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self.model = self.model.to(self.device).eval()

    def trimmed(self, wavs: Sequence[np.ndarray], exact: bool = False) -> np.ndarray:
        """The concatenation, cut at ``max_samples`` and, unless ``exact``,
        down to whole seconds (at least one)."""
        cat = np.concatenate(wavs)[: self.max_samples].astype(np.float32)
        if not exact:
            cat = cat[: max(SAMPLE_RATE, (len(cat) // SAMPLE_RATE) * SAMPLE_RATE)]
        return cat

    @torch.inference_mode()
    def embed_concat(self, wavs: Sequence[np.ndarray], exact: bool = False) -> np.ndarray:
        """A speaker's utterances -> [192]."""
        x = torch.as_tensor(self.trimmed(wavs, exact)[None], device=self.device)
        return sb_encode(self.model, x)[0].float().cpu().numpy()


def precompute_speaker_embeddings(wavs_root: str, out_dir: str, embedder=None,
                                  n_files_per_speaker: int = 50) -> Dict[str, np.ndarray]:
    """``{wavs_root}/{spk}/*.wav`` -> ``{out_dir}/{spk}.npy``, the first
    ``n_files_per_speaker`` files of each speaker in name order
    (pre_spk_emb.py:15-33).  ``embedder`` defaults to ``SpeakerEmbedder()``
    on the card."""
    embedder = embedder or SpeakerEmbedder()
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for spk in sorted(os.listdir(wavs_root)):
        spk_dir = os.path.join(wavs_root, spk)
        if not os.path.isdir(spk_dir):
            continue
        wavs = [load_wav(os.path.join(spk_dir, f))[0]
                for f in sorted(os.listdir(spk_dir))[:n_files_per_speaker] if f.endswith(".wav")]
        if not wavs:
            continue
        emb = embedder.embed_concat(wavs)
        np.save(os.path.join(out_dir, f"{spk}.npy"), emb)
        out[spk] = emb
    return out
