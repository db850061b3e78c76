"""ECAPA-TDNN speaker encoder (JAX package: models/ecapa.py; reference:
text2vec/ecapa_tdnn_TaoRuijie.py:11-206).

Res2Net blocks (scale 8) with squeeze-excitation, attentive statistics
pooling with torch's unbiased variance, BN -> Linear -> BN head.  Layout is
``[B, T, C]`` in and ``[B, n_speaker_dim]`` out.  ``dtype`` is the
convolutions' and ``fc6``'s compute dtype; the BatchNorms have none, as in
the JAX package, and return f32.

``input_wav=True`` takes raw 16 kHz waveforms ``[B, L]`` through the fbank
front end (``wav_to_fbank``: pre-emphasis, Hamming-windowed power
spectrum, 80 HTK mel bands, log, mean over time removed), computed in f32
and without gradient (JAX: ``stop_gradient``); ``conv1`` then takes 80
channels whatever ``n_feat_dim`` says, as flax infers its input width.
``fbank_aug`` is the reference's SpecAugment on that fbank: ``draw_bands``
draws the bands from an explicit ``torch.Generator`` and ``mask_bands``
zeroes them, so that a caller can apply bands drawn elsewhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Conv1d, TorchLinear

N_MELS = 80  # the fbank front end's bands: conv1's input width with input_wav


class SEModule(nn.Module):
    """Squeeze-excitation over time; ``se.1`` and ``se.3`` are the reference's
    Sequential indices (AdaptiveAvgPool, Conv, ReLU, Conv, Sigmoid)."""

    def __init__(self, channels: int, bottleneck: int = 128, dtype=None, device=None):
        super().__init__()
        self.se = nn.Sequential(
            nn.Identity(),  # the reference's AdaptiveAvgPool1d(1) slot
            Conv1d(channels, bottleneck, 1, dtype=dtype, device=device),
            nn.ReLU(),
            Conv1d(bottleneck, channels, 1, dtype=dtype, device=device),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.se(x.mean(dim=1, keepdim=True))


class Bottle2neck(nn.Module):
    def __init__(self, planes: int, kernel_size: int, dilation: int, scale: int = 8,
                 dtype=None, device=None):
        super().__init__()
        width = int(math.floor(planes / scale))
        self.width, self.nums = width, scale - 1
        num_pad = math.floor(kernel_size / 2) * dilation
        self.conv1 = Conv1d(planes, width * scale, 1, dtype=dtype, device=device)
        self.bn1 = BatchNorm(width * scale, device=device)
        self.convs = nn.ModuleList(
            Conv1d(width, width, kernel_size, dilation=dilation, padding=num_pad, dtype=dtype,
                   device=device)
            for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(width, device=device) for _ in range(self.nums))
        self.conv3 = Conv1d(width * scale, planes, 1, dtype=dtype, device=device)
        self.bn3 = BatchNorm(planes, device=device)
        self.se = SEModule(planes, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(F.relu(self.conv1(x)))
        spx = torch.split(out, self.width, dim=-1)
        outs = []
        sp = None
        for i in range(self.nums):
            sp = spx[i] if i == 0 else sp + spx[i]
            sp = self.bns[i](F.relu(self.convs[i](sp)))
            outs.append(sp)
        outs.append(spx[self.nums])
        out = self.bn3(F.relu(self.conv3(torch.cat(outs, dim=-1))))
        return self.se(out) + x


def _pre_emphasis(wav: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """y[t] = x[t] - coef * x[t-1] after a reflect pad of 1 on the left
    (reference: ecapa_tdnn_TaoRuijie.py:80-92)."""
    padded = torch.cat([wav[:, 1:2], wav], dim=1)
    return padded[:, 1:] - coef * padded[:, :-1]


def _htk_mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """torchaudio's default mel filterbank (HTK scale, no norm), built in
    float64 numpy as the JAX package builds it: [n_mels, n_freq] float32."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sr // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).T.astype(np.float32)


def dft_kernel(n_fft: int, win_length: int, device) -> torch.Tensor:
    """[2 * (n_fft // 2 + 1), 1, n_fft]: the cosine rows, then the negated
    sine rows, times a Hamming window of ``win_length`` centred in
    ``n_fft``.  The angles are rounded in f32 in the JAX package's order,
    ``2 pi * k * t / n_fft``, so both packages take the same basis."""
    n_freq = n_fft // 2 + 1
    k = torch.arange(n_freq, dtype=torch.float32, device=device)[:, None]
    t = torch.arange(n_fft, dtype=torch.float32, device=device)[None, :]
    ang = 2.0 * math.pi * k * t / n_fft
    off = (n_fft - win_length) // 2
    pos = torch.arange(n_fft, dtype=torch.float32, device=device)[None, :]
    hamming = 0.54 - 0.46 * torch.cos(2.0 * math.pi * (pos - off) / win_length)
    win = torch.where((pos >= off) & (pos < off + win_length), hamming, 0.0)
    return torch.cat([torch.cos(ang) * win, -torch.sin(ang) * win], dim=0)[:, None, :]


def power_spectrum(x: torch.Tensor, n_fft: int, win_length: int, hop_length: int) -> torch.Tensor:
    """Padded waveforms [B, L] -> |DFT|^2 [B, n_freq, frames] of the
    windowed frames at ``hop_length`` (no padding of its own)."""
    spec = F.conv1d(x[:, None, :], dft_kernel(n_fft, win_length, x.device), stride=hop_length)
    n_freq = n_fft // 2 + 1
    return spec[:, :n_freq] ** 2 + spec[:, n_freq:] ** 2


def wav_to_fbank(wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 512,
                 win_length: int = 400, hop_length: int = 160, f_min: float = 20.0,
                 f_max: float = 7600.0, n_mels: int = N_MELS) -> torch.Tensor:
    """Raw-wav fbank front end (reference: ecapa_tdnn_TaoRuijie.py:138-142
    and 174-176; torchaudio ``MelSpectrogram`` with a Hamming window, power
    2, centre reflect padding, HTK mel, no norm), then ``log(x + 1e-6)``
    less its mean over time.  [B, L] f32 -> [B, frames, n_mels]."""
    x = _pre_emphasis(wav.float())
    x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    power = power_spectrum(x, n_fft, win_length, hop_length)
    fb = torch.from_numpy(_htk_mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max))
    mel = torch.einsum("mf,bft->btm", fb.to(wav.device), power)
    mel = torch.log(mel + 1e-6)
    return mel - mel.mean(dim=1, keepdim=True)


def draw_bands(B: int, T: int, n_mels: int, generator: torch.Generator,
               freq_mask_width=(0, 8), time_mask_width=(0, 10)) -> dict:
    """The bands ``fbank_aug`` zeroes (reference FbankAug,
    ecapa_tdnn_TaoRuijie.py:95-129): per item and axis, a width drawn
    uniformly from the half-open range and a start from
    ``[0, max(1, D - the batch's widest band))``.  Returns
    ``{"time": (width, start), "freq": (width, start)}``, each [B, 1] int64
    on the generator's device."""
    dev = generator.device

    def draw(D, width_range):
        width = torch.randint(width_range[0], width_range[1], (B, 1), generator=generator,
                              device=dev)
        high = max(1, D - int(width.max()))
        start = torch.randint(0, high, (B, 1), generator=generator, device=dev)
        return width, start

    return {"time": draw(T, time_mask_width), "freq": draw(n_mels, freq_mask_width)}


def mask_bands(x: torch.Tensor, bands: dict) -> torch.Tensor:
    """Zero ``bands`` (from ``draw_bands``) of fbank features [B, T, n_mels]:
    the time band, then the frequency band."""
    for axis, name in ((1, "time"), (2, "freq")):
        width, start = (b.to(x.device) for b in bands[name])
        idx = torch.arange(x.shape[axis], device=x.device)[None, :]
        band = (start <= idx) & (idx < start + width)  # [B, D]
        shape = [x.shape[0], 1, 1]
        shape[axis] = x.shape[axis]
        x = torch.where(band.reshape(shape), 0.0, x)
    return x


def fbank_aug(x: torch.Tensor, generator: torch.Generator, freq_mask_width=(0, 8),
              time_mask_width=(0, 10)) -> torch.Tensor:
    """SpecAugment on fbank features [B, T, n_mels]: one zero band along time,
    then one along frequency, per item (JAX: ``fbank_aug``, whose
    ``jax.random`` stream this does not reproduce)."""
    B, T, n_mels = x.shape
    return mask_bands(x, draw_bands(B, T, n_mels, generator, freq_mask_width, time_mask_width))


class ECAPA_TDNN(nn.Module):
    """[B, T, n_feat_dim] wav2vec features (or, with ``input_wav``, [B, L]
    raw waveforms) -> [B, n_speaker_dim] embedding."""

    def __init__(self, C: int = 1024, n_feat_dim: int = 1024, n_speaker_dim: int = 192,
                 input_wav: bool = False, dtype=None, device=None):
        super().__init__()
        self.input_wav = input_wav
        self.conv1 = Conv1d(N_MELS if input_wav else n_feat_dim, C, 5, padding=2, dtype=dtype,
                            device=device)
        self.bn1 = BatchNorm(C, device=device)
        self.layer1 = Bottle2neck(C, 3, 2, dtype=dtype, device=device)
        self.layer2 = Bottle2neck(C, 3, 3, dtype=dtype, device=device)
        self.layer3 = Bottle2neck(C, 3, 4, dtype=dtype, device=device)
        self.layer4 = Conv1d(3 * C, 1536, 1, dtype=dtype, device=device)
        self.attention = nn.Sequential(
            Conv1d(4608, 256, 1, dtype=dtype, device=device),
            nn.ReLU(),
            BatchNorm(256, device=device),
            nn.Tanh(),
            Conv1d(256, 1536, 1, dtype=dtype, device=device),
        )
        self.bn5 = BatchNorm(3072, device=device)
        self.fc6 = TorchLinear(3072, n_speaker_dim, dtype=dtype, device=device)
        self.bn6 = BatchNorm(n_speaker_dim, device=device)

    def forward(self, x: torch.Tensor, aug: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``aug`` (wav path only) masks the fbank with ``fbank_aug`` drawn
        from ``generator``."""
        if self.input_wav:
            with torch.no_grad():
                x = wav_to_fbank(x)
                if aug:
                    x = fbank_aug(x, generator)
        x = self.bn1(F.relu(self.conv1(x)))
        x1 = self.layer1(x)
        x2 = self.layer2(x + x1)
        x3 = self.layer3(x + x1 + x2)
        x = F.relu(self.layer4(torch.cat([x1, x2, x3], dim=-1)))

        mean = x.mean(dim=1, keepdim=True)
        # torch.var is unbiased (ecapa_tdnn_TaoRuijie.py:195); the JAX package
        # writes it as the biased variance times t / max(t - 1, 1)
        t = x.shape[1]
        var = x.var(dim=1, keepdim=True, unbiased=False) * (t / max(t - 1, 1))
        std = torch.sqrt(var.clamp(min=1e-4))
        global_x = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)

        w = torch.softmax(self.attention(global_x), dim=1)  # over time
        mu = torch.sum(x * w, dim=1)
        sg = torch.sqrt((torch.sum(x * x * w, dim=1) - mu * mu).clamp(min=1e-4))
        x = self.bn5(torch.cat([mu, sg], dim=-1))
        return self.bn6(self.fc6(x))
