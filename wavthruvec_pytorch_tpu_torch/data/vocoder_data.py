"""Vec2Wav training data from the host (JAX package: data/vocoder_data.py;
reference: vec2wav/dataset.py:80-228): wav, wav2vec features and speaker
embedding of each item, whole or windowed (``split``), its host log-mel
target, and batches padded to a frame bucket or to the window.

A filelist entry ``train/SSB0000/u0.npy`` names the wav
``{train_wav_path}/train/wav/SSB0000/u0.wav``, the features
``{feat_ground_truth}/train/SSB0000/u0.npy`` and the speaker embedding
``{spk_emb_path}/SSB0000.npy`` (or ``.pth``).  The device-resident cache
``data/vocoder_device_cache.py`` stages what ``VocoderDataset.full_arrays``
reads and batches ``VocoderLoader.epoch_indices``.
"""

from __future__ import annotations

import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.ops.stft import _dft_kernel, _mel_basis
from wavthruvec_pytorch_tpu_torch.parallel.mesh import world_size
from wavthruvec_pytorch_tpu_torch.text import pad_to_bucket

# host RAM a VocoderDataset may fill with cached items (the JAX package's default)
CACHE_BUDGET_BYTES = 4 << 30


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
    """One item a file (JAX package: data/vocoder_data.py ``VocoderDataset``):
    ``wv_feat`` [T, n_feat], ``spk_emb`` [spk_dim], ``audio`` [L]
    (peak-normalised, x 0.95, outside fine-tuning), ``filename`` and, with
    ``compute_mel``, ``mel_loss`` [frames, num_mels], the host log-mel of
    the item's audio.

    * ``split`` (default ``cfg.split``): a window of ``segment_size //
      total_upsample`` latent frames and the audio under them (25 frames and
      8000 samples at ``segment_size`` 8192), from a random start drawn from
      the dataset's ``np.random.default_rng(seed)``; a shorter item is
      zero-padded.  The window is taken in feature space, as the JAX package
      takes it, so that features, audio and mel stay aligned (the
      reference's inactive windowing cuts the audio only).
    * ``fine_tuning``: the reference's branch of precomputed mels from
      ``base_mels_path`` (dataset.py:158-175), as the JAX package has it:
      the audio is not normalised, the windows (with ``split``) are cut at
      hop granularity from the mel's frames and the features stay whole.
    * ``compute_mel`` (default: not ``cfg.device_mel_target``): without it
      the step computes the mel target from the batch's audio, which is
      exact only when every item fills the batch, so it needs ``split``.

    Items are cached in RAM up to ``CACHE_BUDGET_BYTES``: whole items in
    full-utterance mode (every epoch reads the same), the audio and
    features with ``split``.  Loader threads share the window draws under
    one lock, so ``num_workers=0`` gives the JAX package's windows for one
    seed."""

    def __init__(self, files: Sequence[str], cfg: Vec2WavConfig, fine_tuning: bool = False,
                 base_mels_path: Optional[str] = None, split: Optional[bool] = None,
                 seed: int = 1234, compute_mel: Optional[bool] = None):
        self.files = list(files)
        self.cfg = cfg
        self.fine_tuning = fine_tuning
        self.base_mels_path = base_mels_path
        self.split = cfg.split if split is None else split
        self.compute_mel = not cfg.device_mel_target if compute_mel is None else compute_mel
        if not self.compute_mel and not self.split:
            # the host op reflect-pads at each item's end, the step's op sees
            # the batch's zeros there: equal only when items fill the batch
            raise ValueError("device_mel_target requires windowed training (split=True); "
                             "full-utterance mode keeps the host mel target")
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self._audio_cache: Dict[int, np.ndarray] = {}
        self._feat_cache: Dict[int, np.ndarray] = {}
        self._item_cache: Dict[int, Dict] = {}
        self._spk_cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _cache_put(self, store: Dict, key, value, nbytes: int) -> None:
        with self._cache_lock:
            if key not in store and self._cache_bytes + nbytes <= CACHE_BUDGET_BYTES:
                store[key] = value
                self._cache_bytes += nbytes

    def _load_spk(self, spk: str) -> np.ndarray:
        emb = self._spk_cache.get(spk)
        if emb is None:
            npy = os.path.join(self.cfg.spk_emb_path, spk + ".npy")
            emb = load_spk_emb(npy if os.path.exists(npy)
                               else os.path.join(self.cfg.spk_emb_path, spk + ".pth"))
            with self._cache_lock:
                self._spk_cache[spk] = emb
        return emb

    def _draw(self, high: int) -> int:
        with self._rng_lock:  # loader threads share one stream
            return int(self.rng.integers(0, high))

    def _read(self, index: int, cache: bool) -> Tuple[np.ndarray, np.ndarray]:
        """Item ``index``'s whole features [T, n_feat] and audio (normalised
        outside fine-tuning), from the RAM cache or from disk; with
        ``cache`` a read from disk goes into the cache (the features only
        with ``split``: the item cache holds them otherwise)."""
        cfg = self.cfg
        filename = self.files[index]
        parts = filename.split("/")
        audio = self._audio_cache.get(index)
        if audio is None:
            audio, _ = load_wav(os.path.join(cfg.train_wav_path, parts[0], "wav", parts[1],
                                             parts[2][:-4] + ".wav"), cfg.sampling_rate)
            if not self.fine_tuning:
                audio = normalize(audio) * 0.95
            if cache:
                self._cache_put(self._audio_cache, index, audio, audio.nbytes)
        wv_feat = self._feat_cache.get(index)
        if wv_feat is None:
            wv_feat = np.asarray(np.load(os.path.join(cfg.feat_ground_truth, filename))
                                 ).squeeze().astype(np.float32)
            if cache and self.split:
                self._cache_put(self._feat_cache, index, wv_feat, wv_feat.nbytes)
        return wv_feat, audio

    def full_arrays(self, index: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Item ``index`` whole, as the device cache stages it (JAX package:
        ``VocoderDataset.full_arrays``): (features [T, n_feat], normalised
        audio [L], speaker embedding [spk_dim]).  Not for fine-tuning, whose
        windows come from precomputed mels; nothing is cached."""
        if self.fine_tuning:
            raise ValueError("full_arrays: fine_tuning items window precomputed mels; use the "
                             "host path")
        wv_feat, audio = self._read(index, cache=False)
        return wv_feat, audio, self._load_spk(self.files[index].split("/")[1])

    def __getitem__(self, index: int) -> Dict:
        cached = self._item_cache.get(index)
        if cached is not None:
            return cached
        cfg = self.cfg
        filename = self.files[index]
        parts = filename.split("/")
        wv_feat, audio = self._read(index, cache=True)

        if self.fine_tuning:
            audio = self._fine_tuning_window(filename, audio)
        elif self.split:
            wv_feat, audio = self._window(wv_feat, audio)

        item = {"wv_feat": wv_feat, "spk_emb": self._load_spk(parts[1]), "audio": audio,
                "filename": filename}
        nbytes = wv_feat.nbytes + audio.nbytes
        if self.compute_mel:
            item["mel_loss"] = mel_spectrogram_np(audio, cfg.n_fft, cfg.num_mels,
                                                  cfg.sampling_rate, cfg.hop_size, cfg.win_size,
                                                  cfg.fmin, cfg.fmax_for_loss)
            nbytes += item["mel_loss"].nbytes
        if not self.split:
            self._cache_put(self._item_cache, index, item, nbytes)
        return item

    def _window(self, wv_feat: np.ndarray, audio: np.ndarray):
        """``seg_frames`` latent frames from a random start and the
        ``seg_frames * total_upsample`` samples under them."""
        up = self.cfg.total_upsample
        seg_frames = self.cfg.segment_size // up
        seg_samples = seg_frames * up
        T = wv_feat.shape[0]
        if T > seg_frames:
            start = self._draw(T - seg_frames + 1)
            wv_feat = wv_feat[start:start + seg_frames]
            audio = audio[start * up:start * up + seg_samples]
        else:
            wv_feat = np.pad(wv_feat, ((0, seg_frames - T), (0, 0)))
            audio = audio[:seg_samples]
        if len(audio) < seg_samples:
            audio = np.pad(audio, (0, seg_samples - len(audio)))
        return wv_feat, audio

    def _fine_tuning_window(self, filename: str, audio: np.ndarray) -> np.ndarray:
        """The reference's fine-tuning branch: read the precomputed mel and,
        with ``split``, cut the audio at a random mel frame.  As in the JAX
        package the mel itself is not returned: ``mel_loss`` is the windowed
        audio's host mel."""
        cfg = self.cfg
        mel = np.asarray(np.load(os.path.join(
            self.base_mels_path, os.path.splitext(os.path.split(filename)[-1])[0] + ".npy"))
        ).squeeze()
        if not self.split:
            return audio
        frames_per_seg = math.ceil(cfg.segment_size / cfg.hop_size)
        if len(audio) >= cfg.segment_size:
            start = self._draw(max(mel.shape[0] - frames_per_seg - 1, 1))
            return audio[start * cfg.hop_size:(start + frames_per_seg) * cfg.hop_size]
        return np.pad(audio, (0, cfg.segment_size - len(audio)))


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
    """Batches of ``batch_size`` items over a ``VocoderDataset`` (JAX
    package: ``VocoderLoader``), in an order shuffled anew each epoch from
    ``seed``, the last partial batch dropped.
    ``num_workers`` threads load the items of a batch (the reference's
    ``DataLoader(num_workers=8)``; the wav read and the host mel release
    the GIL); ``close`` stops them.  Windowed batches take one static shape,
    ``segment_size // total_upsample`` frames; the others the smallest frame
    bucket that holds their longest item, or with ``pad_to_max`` (default:
    exactly when the world size is above 1, where each rank holds its own
    files and the ranks' batches must have one shape) the largest."""

    def __init__(self, dataset: VocoderDataset, batch_size: int, seed: int = 1234,
                 num_workers: int = 4, pad_to_max: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.num_workers = num_workers
        self._pool: Optional[ThreadPoolExecutor] = None
        self.pad_to_max = world_size() > 1 if pad_to_max is None else pad_to_max

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _get_items(self, idx) -> List[Dict]:
        if self.num_workers and len(idx) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            return list(self._pool.map(self.dataset.__getitem__, [int(i) for i in idx]))
        return [self.dataset[int(i)] for i in idx]

    def epoch_indices(self) -> Iterator[np.ndarray]:
        """Each batch's item indices, in the order ``epoch`` loads them, from
        the same draw of the shuffle (JAX package:
        ``VocoderLoader.epoch_indices``): one epoch takes one of the two."""
        order = self.rng.permutation(len(self.dataset))
        for b in range(len(self)):
            yield order[b * self.batch_size:(b + 1) * self.batch_size]

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        ds = self.dataset
        cfg = ds.cfg
        frame_pad = (cfg.segment_size // cfg.total_upsample if ds.split and not ds.fine_tuning
                     else cfg.frame_buckets[-1] if self.pad_to_max else None)
        for idx in self.epoch_indices():
            yield pad_vocoder_batch(self._get_items(idx), cfg, frame_pad=frame_pad)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
