"""Offline ingest: wavs -> wav2vec 2.0 latents (``.npy``), filelists and a
vocabulary (JAX package: data/ingest.py; reference: prepare_data.py:1-114).

``prepare_data`` featurizes ``n_speakers`` x ``n_files_per_speaker`` wavs of
an AISHELL-3-shaped tree ``{wavs_path}/{spk}/{file}.wav`` into
``{feat_output_path}/{spk}/{file}.npy`` ([1, T, C] float32, as the
reference saves them), writes ``{spk}/{file}.npy|{text}|{spk}`` lines to the
train list (even index within the speaker) and the val list (odd), and the
vocabulary ``'PE '`` + every character seen, sorted.

``Wav2VecFeaturizer`` runs the port's wav2vec 2.0 (``models/wav2vec2.py``)
on batches: each wav normalised to zero mean and unit variance, the batch
zero-padded to a length bucket with a sample mask, and each item's output
cut to its own ``feat_extract_output_lengths``, as the JAX package's
featurizer does.  Weights come from a local checkpoint directory
(``model_path``) or are seeded (``random_init``); nothing is downloaded.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_wav
from wavthruvec_pytorch_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config,
    feat_extract_output_lengths,
    large_config,
    load_pretrained,
    random_model,
)

_STRIP_CHARSET = "PE abcdefghijklmnopqrstuvwxyz0123456789.?"


def clean_label_text(text: str) -> str:
    """AISHELL-3 content.txt cleanup (prepare_data.py:52-55): lowercase,
    strip the latin/digit/punctuation charset, drop the spaces."""
    text = text.lower()
    text = re.sub("[{}]".format(_STRIP_CHARSET), " ", text)
    text = re.sub("[ ]+", "", text)
    return text.strip()


def parse_content_file(label_file_path: str) -> Dict[str, str]:
    """content.txt lines ``{file}\\t{text}`` -> {file: cleaned text}."""
    label_dict: Dict[str, str] = {}
    with open(label_file_path, "r", encoding="utf-8") as f:
        for line in f.readlines():
            _path, text = line.strip().split("\t")
            label_dict[_path] = clean_label_text(text)
    return label_dict


def build_vocab(vocab_path: str, label_dict: Dict[str, str]) -> str:
    """'PE ' + the characters of every label, sorted, as a one-line file."""
    chars = set()
    for v in label_dict.values():
        chars.update(v)
    symbols = "PE " + "".join(sorted(chars))
    os.makedirs(os.path.dirname(vocab_path) or ".", exist_ok=True)
    with open(vocab_path, "w", encoding="utf-8") as fw:
        fw.write(symbols)
    return symbols


class Wav2VecFeaturizer:
    """Batched wav2vec 2.0 features on one device.

    ``model_path``: a local HF checkpoint directory (e.g. TencentGameMate
    ``chinese-wav2vec2-large``: ``config.json`` and ``pytorch_model.bin`` or
    ``model.safetensors``).  ``random_init=True`` builds seeded weights
    (``torch.manual_seed(0)``, as Flax's ``seed=0``) of ``Wav2Vec2Config(**config_overrides)``,
    or of wav2vec 2.0 large (``models.wav2vec2.large_config``) without
    overrides (the JAX package's default there, transformers' default config,
    has group norm, which Flax refuses), for pipeline runs without weights.
    ``device`` defaults to the card and raises without one."""

    def __init__(self, model_path: Optional[str] = None, random_init: bool = False,
                 config_overrides: Optional[dict] = None,
                 wav_buckets: Sequence[int] = (16000, 32000, 64000, 96000, 160000),
                 device=None):
        self.wav_buckets = tuple(wav_buckets)
        if random_init:
            cfg = (Wav2Vec2Config.from_dict(config_overrides) if config_overrides
                   else large_config())
            self.model = random_model(cfg, 0, device=device)
        else:
            if model_path is None:
                raise ValueError("model_path is required (a local checkpoint directory; nothing "
                                 "is downloaded), or pass random_init=True for pipeline runs")
            self.model = load_pretrained(model_path, device=device)
        self.device = next(self.model.parameters()).device
        self.do_normalize = True  # Wav2Vec2FeatureExtractor's default

    def _normalize(self, wav: np.ndarray) -> np.ndarray:
        if self.do_normalize:
            return (wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)
        return wav

    def _bucket(self, n: int) -> int:
        for b in self.wav_buckets:
            if n <= b:
                return b
        return self.wav_buckets[-1]

    def extract_batch(self, wavs: List[np.ndarray]) -> List[np.ndarray]:
        """float32 waveforms -> [T_i, hidden_size] float32 each; a wav past the
        largest bucket is cut to it."""
        pad_len = self._bucket(max(len(w) for w in wavs))
        x = np.zeros((len(wavs), pad_len), np.float32)
        mask = np.zeros((len(wavs), pad_len), np.int64)
        for i, w in enumerate(wavs):
            w = self._normalize(w[:pad_len])
            x[i, : len(w)] = w
            mask[i, : len(w)] = 1
        hidden = self.model(torch.as_tensor(x, device=self.device),
                            torch.as_tensor(mask, device=self.device)).cpu().numpy()
        return [hidden[i, : int(feat_extract_output_lengths(min(len(w), pad_len),
                                                             self.model.cfg))]
                for i, w in enumerate(wavs)]


def prepare_data(wavs_path: str, feat_output_path: str, label_file_path: str,
                 enc_train_list_path: str, enc_val_list_path: str, vocab_path: str,
                 featurizer: Wav2VecFeaturizer, n_speakers: int = 15,
                 n_files_per_speaker: int = 40, batch_size: int = 8) -> None:
    """The full ingest (prepare_data.py:61-114); see the module docstring.  A
    wav without a label is featurized but listed nowhere."""
    label_dict = parse_content_file(label_file_path)
    os.makedirs(feat_output_path, exist_ok=True)
    os.makedirs(os.path.dirname(enc_train_list_path) or ".", exist_ok=True)
    with open(enc_train_list_path, "w", encoding="utf-8") as fw_train, \
            open(enc_val_list_path, "w", encoding="utf-8") as fw_val:
        for spk in sorted(os.listdir(wavs_path))[:n_speakers]:
            spk_path = os.path.join(wavs_path, spk)
            if not os.path.isdir(spk_path):
                continue
            os.makedirs(os.path.join(feat_output_path, spk), exist_ok=True)
            files = sorted(os.listdir(spk_path))[:n_files_per_speaker]
            for start in range(0, len(files), batch_size):
                chunk = files[start: start + batch_size]
                feats = featurizer.extract_batch(
                    [load_wav(os.path.join(spk_path, f))[0] for f in chunk])
                for ind, (fname, feat) in enumerate(zip(chunk, feats), start):
                    suffix = os.path.join(spk, fname[:-4] + ".npy")
                    np.save(os.path.join(feat_output_path, suffix), feat[None])
                    if fname in label_dict:
                        print(f"{suffix}|{label_dict[fname]}|{spk}",
                              file=fw_train if ind % 2 == 0 else fw_val)
    build_vocab(vocab_path, label_dict)
