"""The windowed GAN corpus staged on the card, windows gathered there (JAX
package: data/vocoder_device_cache.py ``VocoderDeviceData``).

The host path windows every item on the host (``VocoderDataset._window``),
pads the batch and copies it to the card each step.  Here the corpus
crosses once, flat: ``flat_feat [sum T, n_feat_dim]``, ``flat_audio
[sum T * 320]`` (each item's normalised audio cut or zero-filled to exactly
T * 320 samples), ``spk_emb [n, spk_dim]``, with a zero tail of one window;
a step's batch is one gather of ``seg_frames = segment_size // 320``
frames and the ``seg_frames * 320`` samples under them from each item's
offset, zeroed past the item's end.  The host draws the window starts and
sends them with the indices: two ``[B]`` vectors a step.

The windows are the JAX device function's, which is not the host path's in
one case: where an item's wav runs past T * 320 samples, the host path of a
short item (T <= seg_frames) reads up to ``seg_samples`` real samples, and
this cache, as JAX's, zero-fills past T * 320 (up to 320 samples).  The
starts are drawn as the host path draws them (uniform on [0, T - seg_frames]
for a longer item, 0 for a shorter one), from ``default_rng(cfg.seed + 7)``,
the JAX cache's stream.

It requires ``split=True``, ``fine_tuning=False`` (whose windows come from
precomputed mels) and ``device_mel_target=True`` (the mel target is then
computed on the card by ``ops/stft.py``, from the window's audio).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.data.device_cache import check_budget, to_card
from wavthruvec_pytorch_tpu_torch.device import resolve_device


class VocoderDeviceData:
    """A windowed ``VocoderDataset`` staged on ``device`` (the card unless
    the caller passes ``"cpu"``), and its batches gathered there."""

    def __init__(self, dataset, cfg: Vec2WavConfig, device=None):
        if not dataset.split or dataset.fine_tuning:
            raise ValueError("VocoderDeviceData requires split=True, fine_tuning=False "
                             "(windowed training mode)")
        if not cfg.device_mel_target:
            raise ValueError("VocoderDeviceData requires device_mel_target=True (the host mel "
                             "target would need the host windowing path)")
        self.cfg = cfg
        self.device = resolve_device(device)
        up = self.up = cfg.total_upsample
        S = self.seg_frames = cfg.segment_size // up
        self.seg_samples = S * up
        n = len(dataset)
        arrays = [dataset.full_arrays(i) for i in range(n)]
        t_lens = np.array([feat.shape[0] for feat, _, _ in arrays], np.int64)
        sum_t = int(t_lens.sum())
        check_budget((sum_t + S) * cfg.n_feat_dim * 4 + (sum_t + S) * up * 4
                     + n * cfg.spk_dim * 4, self.device, f"{n} items")
        self.t_lens_host = t_lens
        feat_off = np.concatenate([[0], np.cumsum(t_lens)[:-1]]).astype(np.int64)
        flat_feat = np.zeros((sum_t + S, cfg.n_feat_dim), np.float32)
        flat_audio = np.zeros((sum_t + S) * up, np.float32)
        for (feat, audio, _), o, T in zip(arrays, feat_off, t_lens):
            flat_feat[o:o + T] = feat
            m = min(len(audio), T * up)
            flat_audio[o * up:o * up + m] = audio[:m]
        self.filenames: List[str] = list(dataset.files)
        dev = self.device
        self.flat_feat = to_card(flat_feat, dev)
        self.flat_audio = to_card(flat_audio, dev)
        self.spk_emb = to_card(np.stack([spk.astype(np.float32) for _, _, spk in arrays]), dev)
        self.feat_off, self.t_lens = to_card(feat_off, dev), to_card(t_lens, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._rng = np.random.default_rng(cfg.seed + 7)
        # the host collate's mel_frames of a full window (split items are
        # padded to seg_samples there, so every item has it)
        pad = (cfg.n_fft - cfg.hop_size) // 2
        L = self.seg_samples
        self.mel_frames = int(np.clip((L + 2 * pad - cfg.n_fft) // cfg.hop_size + 1, 0,
                                      L // cfg.hop_size))

    def nbytes(self) -> int:
        """Bytes staged on the card."""
        return sum(t.numel() * t.element_size() for t in (
            self.flat_feat, self.flat_audio, self.spk_emb, self.feat_off, self.t_lens))

    def draw_fstarts(self, idx) -> np.ndarray:
        """Window starts of items ``idx``: uniform on [0, T - seg_frames]
        for an item longer than a window, 0 otherwise."""
        hi = np.maximum(self.t_lens_host[np.asarray(idx)] - self.seg_frames, 0)
        return self._rng.integers(0, hi + 1).astype(np.int32)

    def batch(self, idx: Sequence[int], fstart: Optional[np.ndarray] = None
              ) -> Dict[str, torch.Tensor]:
        """The windows of items ``idx`` from frames ``fstart`` (drawn by
        ``draw_fstarts`` when not given), gathered on the card:
        ``wv_feat [B, seg_frames, n_feat]``, ``spk_emb [B, spk_dim]``,
        ``audio [B, seg_samples, 1]`` and ``mel_frames [B]``, as
        ``GANTrainer.to_device`` takes them."""
        if fstart is None:
            fstart = self.draw_fstarts(idx)
        dev, up = self.device, self.up
        i = torch.as_tensor(np.asarray(idx, np.int64)).to(dev, non_blocking=True)
        f0 = torch.as_tensor(np.asarray(fstart, np.int64)).to(dev, non_blocking=True)
        T, start = self.t_lens[i], self.feat_off[i] + f0
        ar_f = torch.arange(self.seg_frames, device=dev)
        ar_a = torch.arange(self.seg_samples, device=dev)
        fmask = (f0[:, None] + ar_f[None]) < T[:, None]
        amask = (f0[:, None] * up + ar_a[None]) < T[:, None] * up
        zero = torch.zeros((), device=dev)
        feat = torch.where(fmask[..., None], self.flat_feat[start[:, None] + ar_f[None]], zero)
        audio = torch.where(amask, self.flat_audio[(start * up)[:, None] + ar_a[None]], zero)
        return {"wv_feat": feat, "spk_emb": self.spk_emb[i], "audio": audio[..., None],
                "mel_frames": torch.full_like(i, self.mel_frames)}

    def batch_filenames(self, idx: Sequence[int]) -> List[str]:
        return [self.filenames[int(i)] for i in idx]
