"""The other ECAPA-TDNN of the reference, "lawlict"'s (JAX package:
models/ecapa_lawlict.py; reference: text2vec/ecapa_tdnn_lawlict.py:17-162),
dead code there (model.py imports the TaoRuijie variant) but part of its
surface.  It differs from ``models/ecapa.py``: conv -> ReLU -> BatchNorm,
squeeze-excitation through Linears on the mean over time, the residuals
summed outside the blocks, attentive statistics pooling without the global
context.  As in the JAX package, the aggregating convolution has 1536
output channels whatever ``channels`` is.

Layout ``[B, T, C]``; parameter names are the reference's (``layer1.conv``,
``layer2.0.conv``, ``layer2.1.convs.{i}``, ``layer2.3.linear1``,
``pooling.linear1``, ``bn1``, ``linear``, ``bn2``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Conv1d, TorchLinear

AGG_CHANNELS = 1536


class Conv1dReluBn(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 padding: int = 0, dilation: int = 1, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, padding=padding,
                           dilation=dilation, bias=False, device=device)
        self.bn = BatchNorm(out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(F.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 1, padding: int = 0,
                 dilation: int = 1, scale: int = 4, device=None):
        super().__init__()
        assert channels % scale == 0
        self.scale, self.width = scale, channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv1d(self.width, self.width, kernel_size, padding=padding, dilation=dilation,
                   bias=False, device=device) for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(self.width, device=device) for _ in range(self.nums))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spx = torch.split(x, self.width, dim=-1)
        outs = []
        sp = None
        for i in range(self.nums):
            sp = spx[i] if i == 0 else sp + spx[i]
            sp = self.bns[i](F.relu(self.convs[i](sp)))
            outs.append(sp)
        if self.scale != 1:
            outs.append(spx[self.nums])
        return torch.cat(outs, dim=-1)


class SEConnect(nn.Module):
    def __init__(self, channels: int, s: int = 2, device=None):
        super().__init__()
        self.linear1 = TorchLinear(channels, channels // s, device=device)
        self.linear2 = TorchLinear(channels // s, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.sigmoid(self.linear2(F.relu(self.linear1(x.mean(dim=1)))))
        return x * out[:, None, :]


def se_res2block(channels: int, kernel_size: int, padding: int, dilation: int, scale: int,
                 device=None) -> nn.Sequential:
    """The reference's ``SE_Res2Block``: a Sequential, so its keys are
    ``0`` (pre), ``1`` (res2), ``2`` (post) and ``3`` (SE)."""
    return nn.Sequential(
        Conv1dReluBn(channels, channels, device=device),
        Res2Conv1dReluBn(channels, kernel_size, padding, dilation, scale, device=device),
        Conv1dReluBn(channels, channels, device=device),
        SEConnect(channels, device=device))


class AttentiveStatsPool(nn.Module):
    def __init__(self, in_dim: int, bottleneck_dim: int = 128, device=None):
        super().__init__()
        self.linear1 = Conv1d(in_dim, bottleneck_dim, 1, device=device)
        self.linear2 = Conv1d(bottleneck_dim, in_dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.softmax(self.linear2(torch.tanh(self.linear1(x))), dim=1)
        mean = torch.sum(alpha * x, dim=1)
        residuals = torch.sum(alpha * x * x, dim=1) - mean * mean
        return torch.cat([mean, torch.sqrt(residuals.clamp(min=1e-9))], dim=-1)


class ECAPA_TDNN_Lawlict(nn.Module):
    """[B, T, in_channels] -> [B, embd_dim].  ``device`` defaults to the card
    and raises without one."""

    def __init__(self, in_channels: int = 80, channels: int = 512, embd_dim: int = 192,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.layer1 = Conv1dReluBn(in_channels, channels, kernel_size=5, padding=2, device=device)
        self.layer2 = se_res2block(channels, 3, 2, 2, 8, device=device)
        self.layer3 = se_res2block(channels, 3, 3, 3, 8, device=device)
        self.layer4 = se_res2block(channels, 3, 4, 4, 8, device=device)
        self.conv = Conv1d(3 * channels, AGG_CHANNELS, 1, device=device)
        self.pooling = AttentiveStatsPool(AGG_CHANNELS, 128, device=device)
        self.bn1 = BatchNorm(2 * AGG_CHANNELS, device=device)
        self.linear = TorchLinear(2 * AGG_CHANNELS, embd_dim, device=device)
        self.bn2 = BatchNorm(embd_dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.layer1(x)
        out2 = self.layer2(out1) + out1
        out3 = self.layer3(out1 + out2) + out1 + out2
        out4 = self.layer4(out1 + out2 + out3) + out1 + out2 + out3
        out = F.relu(self.conv(torch.cat([out2, out3, out4], dim=-1)))
        return self.bn2(self.linear(self.bn1(self.pooling(out))))
