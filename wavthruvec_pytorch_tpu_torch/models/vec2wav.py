"""Vec2Wav: the HiFi-GAN generator with Conditional BatchNorm speaker/noise
conditioning, the multi-period and multi-scale discriminators and the GAN
losses (JAX package: models/vec2wav.py; reference: vec2wav/models.py:13-309,
vec2wav/modules.py:5-30).

Reference quirks kept:

* ``resblock == '1'`` against the int 1 selects ResBlock2, which uses only
  the first two dilations (1, 3) of each entry;
* the activation before ``conv_post`` is leaky_relu with slope 0.01, not 0.1;
* Conditional BatchNorm channel counts follow the config;
* the ResBlocks of a stage are averaged: ``xs / num_kernels``;
* the discriminators' widths are fixed (32 to 1024 channels in the MPD,
  128 to 1024 with k = 41 and 16 groups in the MSD), whatever the config.

``Generator(fused=True)`` (the default, what serving builds) runs every
ResBlock2 unit (``x + conv(lrelu(x))``) through
``ops.fused_resblock.fused_conv_residual``: on the card the hand-written
kernel, on the CPU its plain version; it is built in eval mode and runs under
``torch.inference_mode()``.  ``Generator(fused=False)`` is the one that
trains, as in the JAX package: its units are plain ``WNConv1d`` calls, and
its train/eval modes are honoured.

A compute ``dtype`` (bf16) follows flax's ``dtype`` fields (JAX:
models/vec2wav.py:55-411): the convolutions of the Generator, the MPD and
the MSD cast their input, kernel and bias to it and return it; what flax
computes in the promotion of its input and parameters stays f32: the
``fcs`` and the speaker projection of each CBN, the CBN's affine, so the
Generator's residual stream between stages.  So a bf16 Generator returns a
bf16 waveform, the discriminators bf16 scores and feature maps.

* The bf16 GAN step (``GANTrainer`` with ``compute_dtype="bfloat16"``, JAX:
  ``init_state``) builds the three with ``dtype=torch.bfloat16`` and f32
  parameters, which their gradients reach through the casts.
* The bf16 serving Generator (JAX: ``Generator(folded=True,
  dtype=bfloat16)``, built by ``infer.synthesize.make_serving_generator``)
  takes a state dict folded by ``fold_weight_norm`` and stores every
  parameter and statistic in bf16 too.  Its ResBlock2 units do not launch
  the fused kernel (``fused_supported``).

The models read ``Vec2WavConfig.compute_dtype`` nowhere: a bf16 config
builds the f32 Generator for serving, as the JAX package's serving path
does.

The MSD's grouped convolutions take the repack ``ops.tiled_conv`` where
``tiled_conv`` (the config's ``msd_tiled_conv``) is set and its gate
admits the layer (JAX: models/layers.py ``_conv1d_impl``).

Layouts: the Generator takes and returns ``[B, T, C]`` and ``[B, L, 1]``;
the discriminators take waveforms ``[B, L, 1]`` and compute in torch's
layout, so their feature maps are ``[B, C, H, W]`` (MPD) and ``[B, C, T]``
(MSD), the JAX package's transposed.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, check_ported
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.layers import (
    BatchNorm,
    SpectralNormConv1d,
    SpectralNormDense,
    TorchLinear,
    WNConv1d,
    WNConv2d,
    WNConvTranspose1d,
)
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import (
    conv_residual_plain,
    fused_conv_residual,
)

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
                 dilation: Sequence[int] = (1, 3, 5), folded: bool = False, dtype=None,
                 device=None):
        super().__init__()
        wn = dict(w_std=0.01, folded=folded, dtype=dtype, device=device)
        self.convs1 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                     dilation=d, **wn)
            for d in dilation[:3])
        self.convs2 = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1), **wn)
            for _ in dilation[:3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


def fused_supported(dtype: torch.dtype) -> bool:
    """Whether a ResBlock2 unit of a serving Generator launches the fused
    kernel: the dtype clause of the JAX package's gate, ``dtype in (float32,
    None)`` (``ops/fused_resblock.py:153``).  A bf16 unit takes XLA's
    convolution there and ``conv_residual_plain`` in bf16 here, on every
    device; ``fused_conv_residual`` itself refuses anything but f32 on the
    card.  The JAX gate's shape clauses (C % 128, T % 8, a halo) are the TPU
    kernel's; the CUDA kernel takes every width and length."""
    return dtype == torch.float32


class ResBlock2(nn.Module):
    """2 x (lrelu -> dilated conv -> + residual) units (models.py:53-70):
    ``fused`` runs each unit through ``fused_conv_residual`` where
    ``fused_supported`` admits its dtype, else through ``conv_residual_plain``
    (the bf16 serving Generator); without ``fused`` through ``WNConv1d`` as
    autograd sees it."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), fused: bool = True, folded: bool = False,
                 dtype=None, device=None):
        super().__init__()
        self.dilations = tuple(dilation[:2])
        self.fused = fused
        self.convs = nn.ModuleList(
            WNConv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                     dilation=d, w_std=0.01, folded=folded, dtype=dtype, device=device)
            for d in self.dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, d in zip(self.convs, self.dilations):
            if not self.fused:
                x = conv(F.leaky_relu(x, LRELU_SLOPE)) + x
                continue
            w = conv.weight().permute(2, 1, 0)  # [k, C_in, C_out], the compute dtype
            if fused_supported(w.dtype):
                x = fused_conv_residual(x, w.contiguous(), conv.bias, dilation=d,
                                        neg_slope=LRELU_SLOPE)
            else:
                x = conv_residual_plain(x, w, conv.bias, dilation=d, neg_slope=LRELU_SLOPE)
        return x


class Generator(nn.Module):
    """latents [B, T, n_feat] + spk_emb [B, spk_dim] + noise [B, noise_dim]
    -> waveform [B, T * prod(upsample_rates), 1].  ``fused`` selects the
    serving Generator (see the module docstring); ``folded`` takes a state
    dict of ``fold_weight_norm``; ``dtype`` runs the convolutions in that
    dtype, the parameters staying f32 (the serving Generator's caller
    casts them).  ``device`` defaults to the card and raises without one."""

    def __init__(self, cfg: Vec2WavConfig, device=None, fused: bool = True,
                 folded: bool = False, dtype=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.fused = fused
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        ch0 = cfg.upsample_initial_channel
        wn = dict(folded=folded, dtype=dtype, device=device)
        self.conv_pre = WNConv1d(cfg.n_feat_dim, ch0, 7, padding=3, **wn)
        self.ups = nn.ModuleList()
        self.fcs = nn.ModuleList()
        self.cbns = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = ch0 // (2 ** (i + 1))
            self.ups.append(WNConvTranspose1d(ch0 // (2 ** i), ch, k, u, padding=(k - u) // 2,
                                              **wn))
            self.fcs.append(TorchLinear(cfg.spk_dim + cfg.noise_dim, 128, device=device))
            self.cbns.append(ConditionalBatchNorm(ch, device=device))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                if cfg.use_resblock1:
                    self.resblocks.append(ResBlock1(ch, rk, rd, **wn))
                else:
                    self.resblocks.append(ResBlock2(ch, rk, rd, fused=fused, **wn))
        self.conv_post = WNConv1d(ch0 // (2 ** len(cfg.upsample_rates)), 1, 7, padding=3,
                                  w_std=0.01, **wn)
        if fused:
            self.eval()

    def forward(self, x: torch.Tensor, spk_emb: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
        if self.fused:
            with torch.inference_mode():
                return self._forward(x, spk_emb, noise)
        return self._forward(x, spk_emb, noise)

    def _forward(self, x: torch.Tensor, spk_emb: torch.Tensor,
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


def fold_weight_norm(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inference export of a Generator state dict (JAX package:
    ``models/vec2wav.py:463-492``; the reference's ``remove_weight_norm``,
    vec2wav/models.py:149-156): every weight-norm pair ``X.weight_g``,
    ``X.weight_v`` becomes ``weight_v`` = g * v / ||v|| (the normed kernel
    that ``Generator(folded=True)`` uses as it is) and ``weight_g`` = its
    norms, each norm over the dims where ``weight_g`` has size 1, with the
    same 1e-32 under the root.  Spectral norm's ``weight_v`` (no
    ``weight_g`` beside it) and every other entry pass unchanged."""
    out = dict(state)
    for key, g in state.items():
        if not key.endswith(".weight_g"):
            continue
        v_key = key[: -len("weight_g")] + "weight_v"
        v = state[v_key]
        dims = [d for d in range(v.dim()) if g.shape[d] == 1]
        kernel = g * v / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-32)
        out[v_key] = kernel
        out[key] = torch.sqrt(torch.sum(kernel * kernel, dim=dims, keepdim=True) + 1e-32)
    return out


# ---------------------------------------------------------------------------
# Discriminators (reference: vec2wav/models.py:159-275)
# ---------------------------------------------------------------------------

class DiscriminatorP(nn.Module):
    """One period's 2-D conv stack: the waveform, reflect-padded to a
    multiple of the period, as ``[B, 1, L / p, p]`` (models.py:159-192)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3, dtype=None,
                 device=None):
        super().__init__()
        self.period = period
        widths = (1, 32, 128, 512, 1024)
        kw = dict(dtype=dtype, device=device)
        self.convs = nn.ModuleList(
            WNConv2d(c_in, c_out, (kernel_size, 1), (stride, 1), (get_padding(5, 1), 0), **kw)
            for c_in, c_out in zip(widths, widths[1:]))
        self.convs.append(WNConv2d(1024, 1024, (kernel_size, 1), (1, 1), (2, 0), **kw))
        self.conv_post = WNConv2d(1024, 1, (3, 1), (1, 1), (1, 0), **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, L] -> (scores [B, n], 6 feature maps [B, C, H, p])."""
        B, C, L = x.shape
        if L % self.period:
            n_pad = self.period - L % self.period
            x = F.pad(x, (0, n_pad), mode="reflect")
            L += n_pad
        x = x.reshape(B, C, L // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _pair_call(d, y: torch.Tensor, y_hat: torch.Tensor, pair_batched: bool):
    """A discriminator on the real and the generated waveform: one call over
    ``cat([y, y_hat])`` when ``pair_batched``, else two."""
    if not pair_batched:
        return d(y) + d(y_hat)
    B = y.shape[0]
    o, fmap = d(torch.cat([y, y_hat], dim=0))
    return o[:B], [m[:B] for m in fmap], o[B:], [m[B:] for m in fmap]


class MultiPeriodDiscriminator(nn.Module):
    """One ``DiscriminatorP`` per period of ``cfg.periods`` (13, 17, 19 in
    the reference; models.py:195-215).  ``pair_batched`` (the config's
    ``disc_pair_batched``): one pass over ``cat([y, y_hat])`` instead of two;
    the convolutions see each item alone, so the result is the same.
    ``dtype``: the convolutions' compute dtype (see the module docstring)."""

    def __init__(self, cfg: Vec2WavConfig, pair_batched: bool = True, dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        self.pair_batched = pair_batched
        self.discriminators = nn.ModuleList(DiscriminatorP(p, dtype=dtype, device=device)
                                            for p in cfg.periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, L, 1] -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs), one
        entry per period."""
        y, y_hat = y.transpose(1, 2), y_hat.transpose(1, 2)  # [B, 1, L]
        outs = [_pair_call(d, y, y_hat, self.pair_batched) for d in self.discriminators]
        y_d_rs, fmap_rs, y_d_gs, fmap_gs = (list(t) for t in zip(*outs))
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


def _avg_pool_4_2_pad2(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool1d(4, 2, padding=2) over [B, C, L], the padding counted."""
    return F.avg_pool1d(x, 4, 2, padding=2, count_include_pad=True)


# (out channels, kernel, stride, groups, padding) of the MSD's conv stack
_MSD_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
              (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
              (1024, 5, 1, 1, 2))


class DiscriminatorS(nn.Module):
    """One scale's grouped 1-D conv stack over [B, 1, L] (models.py:218-243),
    spectral-normed or weight-normed.  ``tiled_conv`` routes the grouped
    convolutions through the repack ``ops.tiled_conv`` where its gate
    admits them, as the JAX package's ``tiled_conv`` does; the values stay
    those of the grouped convolution.  ``dtype``: the convolutions' compute
    dtype."""

    def __init__(self, use_spectral_norm: bool = False, tiled_conv: bool = False, dtype=None,
                 device=None):
        super().__init__()
        conv = SpectralNormConv1d if use_spectral_norm else WNConv1d
        kw = dict(dtype=dtype, device=device)
        c_in = 1
        self.convs = nn.ModuleList()
        for c_out, k, s, g, p in _MSD_SPECS:
            self.convs.append(conv(c_in, c_out, k, stride=s, padding=p, groups=g,
                                   tiled=tiled_conv, **kw))
            c_in = c_out
        self.conv_post = conv(1024, 1, 3, stride=1, padding=1, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x [B, 1, L] -> (scores [B, n], 8 feature maps [B, C, T])."""
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv.conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post.conv(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Three ``DiscriminatorS``, the first spectral-normed, with
    ``AvgPool1d(4, 2, 2)`` between scales (models.py:246-275).  In train mode
    the first scale takes one power iteration per call of its discriminator:
    once per MSD call under ``pair_batched``, twice without it (the
    reference's per-forward hook; PARITY.md).  ``tiled_conv`` and ``dtype``
    reach every scale (``DiscriminatorS``)."""

    def __init__(self, pair_batched: bool = True, tiled_conv: bool = False, dtype=None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.pair_batched = pair_batched
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), tiled_conv=tiled_conv, dtype=dtype,
                           device=device) for i in range(3))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat [B, L, 1] -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs), one
        entry per scale."""
        y, y_hat = y.transpose(1, 2), y_hat.transpose(1, 2)  # [B, 1, L]
        outs = []
        for i, d in enumerate(self.discriminators):
            if i:
                y, y_hat = _avg_pool_4_2_pad2(y), _avg_pool_4_2_pad2(y_hat)
            outs.append(_pair_call(d, y, y_hat, self.pair_batched))
        y_d_rs, fmap_rs, y_d_gs, fmap_gs = (list(t) for t in zip(*outs))
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ---------------------------------------------------------------------------
# GAN losses (reference: vec2wav/models.py:278-309)
# ---------------------------------------------------------------------------

def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl - gl))
    return loss * 2.0


def discriminator_loss(disc_real_outputs, disc_generated_outputs):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr) ** 2)
        g_loss = torch.mean(dg ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses
