"""ECAPA-TDNN speaker encoder, feature-input path, eval mode (JAX package:
models/ecapa.py ``ECAPA_TDNN`` with ``input_wav=False``; reference:
text2vec/ecapa_tdnn_TaoRuijie.py:11-206).

Res2Net blocks (scale 8) with squeeze-excitation, attentive statistics
pooling with torch's unbiased variance, BN -> Linear -> BN head.  Layout is
``[B, T, C]`` in and ``[B, n_speaker_dim]`` out.  ``dtype`` is the
convolutions' and ``fc6``'s compute dtype; the BatchNorms have none, as in
the JAX package, and return f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Conv1d, TorchLinear


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


class ECAPA_TDNN(nn.Module):
    """[B, T, n_feat_dim] wav2vec features -> [B, n_speaker_dim] embedding."""

    def __init__(self, C: int = 1024, n_feat_dim: int = 1024, n_speaker_dim: int = 192,
                 dtype=None, device=None):
        super().__init__()
        self.conv1 = Conv1d(n_feat_dim, C, 5, padding=2, dtype=dtype, device=device)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
