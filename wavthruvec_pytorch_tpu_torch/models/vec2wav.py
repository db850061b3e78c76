"""Vec2Wav generator: HiFi-GAN with Conditional BatchNorm speaker/noise
conditioning, inference only (JAX package: models/vec2wav.py
``ConditionalBatchNorm``, ``ResBlock1``, ``ResBlock2``, ``Generator``;
reference: vec2wav/models.py:13-156, vec2wav/modules.py:5-30).

Reference quirks kept:

* ``resblock == '1'`` against the int 1 selects ResBlock2, which uses only
  the first two dilations (1, 3) of each entry;
* the activation before ``conv_post`` is leaky_relu with slope 0.01, not 0.1;
* Conditional BatchNorm channel counts follow the config;
* the ResBlocks of a stage are averaged: ``xs / num_kernels``.

Every ResBlock2 unit (``x + conv(lrelu(x))``) runs through
``ops.fused_resblock.fused_conv_residual``: on the card the hand-written
kernel, on the CPU its plain version.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, check_ported
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.layers import (
    BatchNorm,
    SpectralNormDense,
    WNConv1d,
    WNConvTranspose1d,
)
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import fused_conv_residual

LRELU_SLOPE = 0.1


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return int((kernel_size * dilation - dilation) / 2)


class ConditionalBatchNorm(nn.Module):
    """BN(affine=False) + spectral-norm Linear(z -> 2C) giving per-sample
    gamma/beta; ``batch_nrom`` is the reference's attribute name
    (vec2wav/modules.py:14)."""

    def __init__(self, num_features: int, z_channels: int = 128, device=None):
        super().__init__()
        self.batch_nrom = BatchNorm(num_features, affine=False, device=device)
        self.layer = SpectralNormDense(z_channels, 2 * num_features, w_mean=1.0,
                                       w_std=0.02, device=device)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.layer(z).chunk(2, dim=-1)
        return gamma[:, None, :] * self.batch_nrom(x) + beta[:, None, :]


class ResBlock1(nn.Module):
    """3 x (lrelu -> dilated conv -> lrelu -> conv) residual (models.py:13-50)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), device=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                     dilation=d, w_std=0.01, device=device)
            for d in dilation[:3])
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1),
                     w_std=0.01, device=device)
            for _ in dilation[:3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """2 x fused (lrelu -> dilated conv -> + residual) units (models.py:53-70)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), device=None):
        super().__init__()
        self.dilations = tuple(dilation[:2])
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                     dilation=d, w_std=0.01, device=device)
            for d in self.dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, d in zip(self.convs, self.dilations):
            w = conv.weight().permute(2, 1, 0).contiguous()  # [k, C_in, C_out]
            x = fused_conv_residual(x, w, conv.bias, dilation=d, neg_slope=LRELU_SLOPE)
        return x


class Generator(nn.Module):
    """latents [B, T, n_feat] + spk_emb [B, spk_dim] + noise [B, noise_dim]
    -> waveform [B, T * prod(upsample_rates), 1].  ``device`` defaults to the
    card and raises without one."""

    def __init__(self, cfg: Vec2WavConfig, device=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        ch0 = cfg.upsample_initial_channel
        self.conv_pre = WNConv1d(cfg.n_feat_dim, ch0, 7, padding=3, device=device)
        self.ups = nn.ModuleList()
        self.fcs = nn.ModuleList()
        self.cbns = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch0 // (2 ** i), ch, k, u, padding=(k - u) // 2,
                                              device=device))
            self.fcs.append(nn.Linear(cfg.spk_dim + cfg.noise_dim, 128, device=device))
            self.cbns.append(ConditionalBatchNorm(ch, device=device))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                block = ResBlock1 if cfg.use_resblock1 else ResBlock2
                self.resblocks.append(block(ch, rk, rd, device=device))
        self.conv_post = WNConv1d(ch0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3,
                                  w_std=0.01, device=device)
        self.eval()

    @torch.inference_mode()
    def forward(self, x: torch.Tensor, spk_emb: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        spk_noise = torch.cat([spk_emb, noise], dim=-1)
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = self.cbns[i](x, self.fcs[i](spk_noise)).contiguous()
            xs = None
            for j in range(self.num_kernels):
                out = self.resblocks[i * self.num_kernels + j](x)
                xs = out if xs is None else xs + out
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x))  # torch's default slope 0.01 (models.py:143)
        return torch.tanh(x)
