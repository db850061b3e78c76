"""Vec2Wav training data, whole utterances from the host (JAX package:
data/vocoder_data.py; reference: vec2wav/dataset.py:80-228): wav, wav2vec
features and speaker embedding of each item, its host log-mel target, and
batches padded to a frame bucket.

A filelist entry ``train/SSB0000/u0.npy`` names the wav
``{train_wav_path}/train/wav/SSB0000/u0.wav``, the features
``{feat_ground_truth}/train/SSB0000/u0.npy`` and the speaker embedding
``{spk_emb_path}/SSB0000.npy`` (or ``.pth``).  Windowed training
(``split=True``), the fine-tuning mode (windows of precomputed mels), the
in-step mel target in the loader and the device-resident cache are not
ported (ROADMAP.md, queue 1 item 9); nor is the JAX loader's item cache:
every epoch reads the files again.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, check_ported
from wavthruvec_pytorch_tpu_torch.ops.stft import _dft_kernel, _mel_basis
from wavthruvec_pytorch_tpu_torch.text import pad_to_bucket


def load_wav(path: str, target_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """float32 mono waveform in [-1, 1] (the reference's librosa.load at
    16 kHz; here scipy, with polyphase resampling)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = math.gcd(sr, target_sr)
        data = resample_poly(data, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return data, sr


def normalize(audio: np.ndarray) -> np.ndarray:
    """librosa.util.normalize: peak to 1.0 (dataset.py:133)."""
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio


def mel_spectrogram_np(y: np.ndarray, n_fft: int, num_mels: int, sampling_rate: int,
                       hop_size: int, win_size: int, fmin: float, fmax: Optional[float]
                       ) -> np.ndarray:
    """Host twin of ``ops.stft.mel_spectrogram``: [L] -> [frames, num_mels],
    with the same reflect pad, windowed DFT basis and slaney filterbank."""
    pad = int((n_fft - hop_size) / 2)
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = (len(y) - n_fft) // hop_size + 1
    idx = np.arange(n_fft)[None, :] + hop_size * np.arange(n_frames)[:, None]
    spec = y[idx] @ _dft_kernel(n_fft, win_size)[:, 0, :].T  # [frames, 2F]
    n_freq = n_fft // 2 + 1
    mag = np.sqrt(spec[:, :n_freq] ** 2 + spec[:, n_freq:] ** 2 + 1e-9)
    mel = mag @ _mel_basis(sampling_rate, n_fft, num_mels, fmin, fmax).T  # [frames, M]
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


def get_dataset_filelist(input_training_file: str, input_validation_file: str
                         ) -> Tuple[List[str], List[str]]:
    """The first ``|`` field of each line of both filelists (dataset.py:80-87)."""
    def read(p):
        with open(p, "r", encoding="utf-8") as f:
            return [x.split("|")[0] for x in f.read().split("\n") if len(x) > 0]

    return read(input_training_file), read(input_validation_file)


def load_spk_emb(path: str) -> np.ndarray:
    """A speaker embedding from ``.npy``, or the reference's torch ``.pth``."""
    if path.endswith(".npy"):
        return np.load(path).squeeze().astype(np.float32)
    import torch

    return torch.load(path, map_location="cpu").squeeze().numpy().astype(np.float32)


class VocoderDataset:
    """One whole utterance an item: ``wv_feat`` [T, n_feat], ``spk_emb``
    [spk_dim], ``audio`` [L] (peak-normalised, x 0.95), ``mel_loss``
    [frames, num_mels] (its host log-mel) and ``filename``."""

    def __init__(self, files: Sequence[str], cfg: Vec2WavConfig):
        check_ported(cfg, training=True)
        if cfg.device_mel_target:
            # as the JAX dataset: the in-step target is exact only when every
            # item fills the batch length, which windowed training guarantees
            raise ValueError("device_mel_target requires windowed training (split=True); "
                             "full-utterance mode keeps the host mel target")
        self.files = list(files)
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        filename = self.files[index]
        parts = filename.split("/")
        wav_file = os.path.join(cfg.train_wav_path, parts[0], "wav", parts[1],
                                parts[2][:-4] + ".wav")
        audio, _ = load_wav(wav_file, cfg.sampling_rate)
        audio = normalize(audio) * 0.95
        wv_feat = np.asarray(np.load(os.path.join(cfg.feat_ground_truth, filename))
                             ).squeeze().astype(np.float32)
        spk_npy = os.path.join(cfg.spk_emb_path, parts[1] + ".npy")
        spk_emb = load_spk_emb(spk_npy if os.path.exists(spk_npy)
                               else os.path.join(cfg.spk_emb_path, parts[1] + ".pth"))
        mel = mel_spectrogram_np(audio, cfg.n_fft, cfg.num_mels, cfg.sampling_rate, cfg.hop_size,
                                 cfg.win_size, cfg.fmin, cfg.fmax_for_loss)
        return {"wv_feat": wv_feat, "spk_emb": spk_emb, "audio": audio, "mel_loss": mel,
                "filename": filename}


def pad_vocoder_batch(items: List[Dict], cfg: Vec2WavConfig, frame_pad: Optional[int] = None
                      ) -> Dict[str, np.ndarray]:
    """Pad items to a frame bucket T (the smallest ``frame_buckets`` entry
    that holds the longest item, unless ``frame_pad`` says): ``wv_feat``
    [B, T, C], ``audio`` [B, T * total_upsample, 1], ``spk_emb`` [B, D], and
    ``mel_loss`` [B, L / hop, M] when the items carry it, else ``mel_frames``
    [B], the frames the host op would give each item (the in-step target is
    masked past them).  Longer items are cut to the bucket."""
    B = len(items)
    T = frame_pad or pad_to_bucket(max(it["wv_feat"].shape[0] for it in items),
                                   cfg.frame_buckets)
    L = T * cfg.total_upsample
    n_mel_frames = L // cfg.hop_size
    with_mel = "mel_loss" in items[0]
    wv = np.zeros((B, T, cfg.n_feat_dim), np.float32)
    audio = np.zeros((B, L, 1), np.float32)
    mel = np.zeros((B, n_mel_frames, cfg.num_mels), np.float32)
    mel_frames = np.zeros((B,), np.int32)
    spk = np.zeros((B, cfg.spk_dim), np.float32)
    pad = (cfg.n_fft - cfg.hop_size) // 2
    for i, it in enumerate(items):
        t = min(it["wv_feat"].shape[0], T)
        wv[i, :t] = it["wv_feat"][:t]
        a = it["audio"][:L]
        audio[i, :len(a), 0] = a
        if with_mel:
            m = it["mel_loss"][:n_mel_frames]
            mel[i, :m.shape[0]] = m
        else:
            mel_frames[i] = np.clip((len(a) + 2 * pad - cfg.n_fft) // cfg.hop_size + 1,
                                    0, n_mel_frames)
        spk[i] = it["spk_emb"]
    out = {"wv_feat": wv, "spk_emb": spk, "audio": audio,
           "filenames": [it["filename"] for it in items]}
    if with_mel:
        out["mel_loss"] = mel
    else:
        out["mel_frames"] = mel_frames
    return out


class VocoderLoader:
    """Batches of ``batch_size`` items in an order shuffled anew each epoch
    from ``seed``; the last partial batch is dropped."""

    def __init__(self, dataset: VocoderDataset, batch_size: int, seed: int = 1234):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self.rng.permutation(len(self.dataset))
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield pad_vocoder_batch([self.dataset[int(i)] for i in idx], self.dataset.cfg)
