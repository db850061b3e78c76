"""Differentiable log-mel spectrogram for the vocoder's mel loss (JAX
package: ops/stft.py ``mel_spectrogram``, ``stft_magnitude``; reference:
vec2wav/dataset.py:23-77).

Framing is ``Tensor.unfold`` (a view; its gradient is a scatter-add), the
window and DFT are one matmul with the windowed DFT basis, and the magnitude
is ``sqrt(re^2 + im^2 + 1e-9)``.  ``torch.stft`` is not used: the JAX package
dropped its conv form because that form's gradient is slow under the GAN
step, and a matmul with the same basis is also the closest in rounding.

The numpy ``mel_filterbank`` (slaney scale and norm, as
``librosa.filters.mel``), ``hann_window`` and ``_dft_kernel`` are the port's
own copies of the JAX package's; the host twin ``mel_spectrogram_np`` lives
in ``data/vocoder_data.py``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-normalized triangular mel filterbank."""
    if fmax is None:
        fmax = float(sr) / 2
    fftfreqs = np.linspace(0.0, float(sr) / 2, n_fft // 2 + 1)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def hann_window(win_size: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window's default)."""
    n = np.arange(win_size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_size))).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_kernel(n_fft: int, win_size: int) -> np.ndarray:
    """Windowed DFT basis [2 * (n_fft//2 + 1), 1, n_fft]: the real (cos)
    rows, then the imaginary (-sin) rows, times the Hann window centred in
    n_fft (torch.stft's padding of a shorter window).  Read-only: shared by
    every caller."""
    n_freq = n_fft // 2 + 1
    win = np.zeros(n_fft, dtype=np.float64)
    off = (n_fft - win_size) // 2
    win[off:off + win_size] = hann_window(win_size).astype(np.float64)
    angles = (2.0 * np.pi * np.arange(n_freq, dtype=np.float64)[:, None]
              * np.arange(n_fft, dtype=np.float64)[None, :] / n_fft)
    kernel = np.concatenate([np.cos(angles) * win, -np.sin(angles) * win], axis=0)[:, None, :]
    kernel = kernel.astype(np.float32)
    kernel.setflags(write=False)
    return kernel


@functools.lru_cache(maxsize=8)
def _mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]
               ) -> np.ndarray:
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    basis.setflags(write=False)
    return basis


@functools.lru_cache(maxsize=8)
def _device_dft(n_fft: int, win_size: int, device: torch.device) -> torch.Tensor:
    """The DFT basis [2F, n_fft] as an f32 tensor on ``device``, made once."""
    return torch.tensor(_dft_kernel(n_fft, win_size)[:, 0, :], device=device)


@functools.lru_cache(maxsize=8)
def _device_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float],
                      device: torch.device) -> torch.Tensor:
    return torch.tensor(_mel_basis(sr, n_fft, n_mels, fmin, fmax), device=device)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int,
                   center: bool = False, mag_eps: float = 1e-9) -> torch.Tensor:
    """[B, L] waveform -> [B, n_fft//2 + 1, frames] magnitude, as
    ``torch.stft(..., center=center, onesided=True)`` then
    ``sqrt(re^2 + im^2 + mag_eps)``."""
    if center:
        y = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = y.float().unfold(-1, n_fft, hop_size)  # [B, frames, n_fft]
    spec = torch.matmul(frames, _device_dft(n_fft, win_size, y.device).t()).transpose(1, 2)
    n_freq = n_fft // 2 + 1
    real, imag = spec[:, :n_freq], spec[:, n_freq:]  # [B, F, frames] each
    return torch.sqrt(real * real + imag * imag + mag_eps)


def mel_spectrogram(y: torch.Tensor, n_fft: int, num_mels: int, sampling_rate: int,
                    hop_size: int, win_size: int, fmin: float, fmax: Optional[float]
                    ) -> torch.Tensor:
    """[B, L] waveform -> [B, num_mels, frames] log-mel: reflect pad of
    (n_fft - hop)/2 a side, the magnitude STFT, the slaney mel basis, then
    ``log(clamp(mel, 1e-5))``."""
    pad = int((n_fft - hop_size) / 2)
    spec = stft_magnitude(F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0], n_fft, hop_size,
                          win_size)
    basis = _device_mel_basis(sampling_rate, n_fft, num_mels, fmin, fmax, y.device)
    return torch.log(torch.clamp(torch.matmul(basis, spec), min=1e-5))
