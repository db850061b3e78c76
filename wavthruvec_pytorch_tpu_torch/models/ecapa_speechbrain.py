"""SpeechBrain's ECAPA-TDNN (``spkrec-ecapa-voxceleb``), the speaker encoder
the reference conditions Vec2Wav on (vec2wav/pre_spk_emb.py:12,30) (JAX
package: models/ecapa_speechbrain.py).

It differs from ``models/ecapa.py``: TDNN blocks with reflect-padded
convolutions, SE-Res2Net blocks whose first channel chunk passes through,
multi-layer feature aggregation (``mfa``) over the three blocks' outputs,
attentive statistics pooling with global context at eps 1e-12 and a 192-d
head; in front of it an 80-band fbank (Hamming 25 ms / 10 ms, a constant-
padded STFT, SpeechBrain's triangular filters, dB with top_db 80) and a
per-utterance mean subtraction (``sb_fbank``, ``sentence_norm``).

Layout ``[B, T, C]``.  Parameter names are SpeechBrain's (``blocks.0.conv.
conv.weight``, ``blocks.{i}.res2net_block.blocks.{j}...``, ``mfa``,
``asp``, ``asp_bn``, ``fc``), so the bundle's ``embedding_model.ckpt``
loads with ``strict=True`` once an ``embedding_model.`` prefix is stripped
(``load_speechbrain_state_dict``).  The published widths are the defaults:
channels (1024, 1024, 1024, 1024, 3072), kernels (5, 3, 3, 3, 1),
dilations (1, 2, 3, 4, 1), Res2Net scale 8, SE 128, attention 128.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.ecapa import power_spectrum
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Conv1d


def _sb_mel_filterbank(sample_rate: int = 16000, n_fft: int = 400, n_mels: int = 80,
                       f_min: float = 0.0, f_max: Optional[float] = None) -> np.ndarray:
    """SpeechBrain ``Filterbank``'s triangles: mel-spaced centres, each as
    wide as the gap to the next centre on both sides.  [n_freq, n_mels]
    float32, built in float64 numpy as the JAX package builds it."""
    if f_max is None:
        f_max = sample_rate / 2

    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    hz = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]
    slope = (all_freqs[:, None] - hz[1:-1][None, :]) / band[None, :]
    return np.clip(np.minimum(slope + 1.0, -slope + 1.0), 0.0, None).astype(np.float32)


def sb_fbank(wav: torch.Tensor, sample_rate: int = 16000, n_fft: int = 400,
             win_length: int = 400, hop_length: int = 160, n_mels: int = 80,
             amin: float = 1e-10, top_db: float = 80.0) -> torch.Tensor:
    """[B, L] waveform -> [B, frames, n_mels] dB mel: a centre, constant-
    padded STFT with a Hamming window, the power spectrum, the triangular
    filters, ``10 log10(max(x, amin))`` floored at the batch's maximum less
    ``top_db`` (SpeechBrain clips against the whole batch tensor's max)."""
    x = F.pad(wav.float(), (n_fft // 2, n_fft // 2))
    power = power_spectrum(x, n_fft, win_length, hop_length)
    fb = torch.from_numpy(_sb_mel_filterbank(sample_rate, n_fft, n_mels)).to(wav.device)
    mel = torch.einsum("fm,bft->btm", fb, power)
    x_db = 10.0 * torch.log10(torch.clamp(mel, min=amin))
    return torch.maximum(x_db, x_db.max() - top_db)


def sentence_norm(feats: torch.Tensor) -> torch.Tensor:
    """``InputNormalization(norm_type="sentence", std_norm=False)``: each
    utterance's mean over time removed, per feature."""
    return feats - feats.mean(dim=1, keepdim=True)


class SBConv1d(nn.Module):
    """SpeechBrain's Conv1d: 'same' length through a reflect pad of
    ``dilation * (kernel - 1) / 2`` a side (odd kernels)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, device=None):
        super().__init__()
        self.pad = dilation * (kernel_size - 1) // 2
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x.transpose(1, 2), (self.pad, self.pad), mode="reflect").transpose(1, 2)
        return self.conv(x)


class SBBatchNorm(nn.Module):
    """SpeechBrain's BatchNorm1d wrapper (its module sits at ``.norm``)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.norm = BatchNorm(num_features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class SBTDNNBlock(nn.Module):
    """conv -> ReLU -> BatchNorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int = 1, device=None):
        super().__init__()
        self.conv = SBConv1d(in_channels, out_channels, kernel_size, dilation, device=device)
        self.norm = SBBatchNorm(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class SBRes2NetBlock(nn.Module):
    """Channel chunks: chunk 0 passes through, chunk i >= 1 through TDNN
    block i - 1, from chunk 2 on with the previous output added."""

    def __init__(self, channels: int, scale: int, kernel_size: int, dilation: int, device=None):
        super().__init__()
        self.scale = scale
        hidden = channels // scale
        self.blocks = nn.ModuleList(SBTDNNBlock(hidden, hidden, kernel_size, dilation,
                                                device=device) for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=-1)
        y = [chunks[0]]
        for i in range(1, self.scale):
            y.append(self.blocks[i - 1](chunks[i] if i == 1 else chunks[i] + y[-1]))
        return torch.cat(y, dim=-1)


class SBSEBlock(nn.Module):
    """Squeeze-excitation: the mean over time -> conv1 -> ReLU -> conv2 ->
    sigmoid, times the input."""

    def __init__(self, channels: int, se_channels: int, device=None):
        super().__init__()
        self.conv1 = SBConv1d(channels, se_channels, 1, device=device)
        self.conv2 = SBConv1d(se_channels, channels, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.conv2(F.relu(self.conv1(x.mean(dim=1, keepdim=True)))))
        return s * x


class SBSERes2NetBlock(nn.Module):
    def __init__(self, channels: int, res2net_scale: int, se_channels: int, kernel_size: int,
                 dilation: int, device=None):
        super().__init__()
        self.tdnn1 = SBTDNNBlock(channels, channels, 1, device=device)
        self.res2net_block = SBRes2NetBlock(channels, res2net_scale, kernel_size, dilation,
                                            device=device)
        self.tdnn2 = SBTDNNBlock(channels, channels, 1, device=device)
        self.se_block = SBSEBlock(channels, se_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in == out channels in the published config: no shortcut convolution
        return self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x)))) + x


class SBAttentiveStatsPooling(nn.Module):
    """Attentive statistics pooling with global context, eps 1e-12:
    [B, T, C] -> [B, 1, 2C]."""

    def __init__(self, channels: int, attention_channels: int = 128, eps: float = 1e-12,
                 device=None):
        super().__init__()
        self.eps = eps
        self.tdnn = SBTDNNBlock(3 * channels, attention_channels, 1, device=device)
        self.conv = SBConv1d(attention_channels, channels, 1, device=device)

    def _stats(self, x: torch.Tensor, w: torch.Tensor):
        mean = torch.sum(w * x, dim=1)
        var = torch.sum(w * (x - mean[:, None, :]) ** 2, dim=1)
        return mean, torch.sqrt(var.clamp(min=self.eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        mean, std = self._stats(x, torch.full((1, T, 1), 1.0 / T, dtype=x.dtype, device=x.device))
        attn = torch.cat([x, mean[:, None, :].expand_as(x), std[:, None, :].expand_as(x)], dim=-1)
        attn = self.conv(torch.tanh(self.tdnn(attn)))
        mean, std = self._stats(x, torch.softmax(attn, dim=1))  # over time
        return torch.cat([mean, std], dim=-1)[:, None, :]


class ECAPA_TDNN_SB(nn.Module):
    """SpeechBrain's ECAPA-TDNN embedding model: [B, T, n_mels] -> [B,
    lin_neurons].  ``device`` defaults to the card and raises without one."""

    def __init__(self, input_size: int = 80,
                 channels: Sequence[int] = (1024, 1024, 1024, 1024, 3072),
                 kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1),
                 dilations: Sequence[int] = (1, 2, 3, 4, 1), attention_channels: int = 128,
                 res2net_scale: int = 8, se_channels: int = 128, lin_neurons: int = 192,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        blocks = [SBTDNNBlock(input_size, channels[0], kernel_sizes[0], dilations[0],
                              device=device)]
        for i in range(1, len(channels) - 1):
            blocks.append(SBSERes2NetBlock(channels[i], res2net_scale, se_channels,
                                           kernel_sizes[i], dilations[i], device=device))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = SBTDNNBlock(sum(channels[1:-1]), channels[-1], kernel_sizes[-1],
                               dilations[-1], device=device)
        self.asp = SBAttentiveStatsPooling(channels[-1], attention_channels, device=device)
        self.asp_bn = SBBatchNorm(2 * channels[-1], device=device)
        self.fc = SBConv1d(2 * channels[-1], lin_neurons, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xl = []
        for block in self.blocks:
            x = block(x)
            xl.append(x)
        # multi-layer feature aggregation over the SE-Res2Net blocks' outputs
        x = self.mfa(torch.cat(xl[1:], dim=-1))
        return self.fc(self.asp_bn(self.asp(x)))[:, 0, :]


def sb_encode(model: ECAPA_TDNN_SB, wav: torch.Tensor) -> torch.Tensor:
    """``EncoderClassifier.encode_batch`` on [B, L] waveforms: fbank,
    sentence mean normalisation, the embedding model (in its current mode)."""
    return model(sentence_norm(sb_fbank(wav)))


def load_speechbrain_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An ``embedding_model.ckpt`` state dict with its ``embedding_model.``
    prefix, if any, stripped: the keys ``ECAPA_TDNN_SB`` loads strictly."""
    p = "embedding_model."
    return {k[len(p):] if k.startswith(p) else k: v for k, v in sd.items()}
