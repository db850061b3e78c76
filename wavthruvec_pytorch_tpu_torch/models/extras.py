"""The reference's auxiliary Prenet and PostNet (JAX package:
models/extras.py): defined, never instantiated there (``Prenet``/``PreNet``
at text2vec/module.py:263-284 and text2vec/subLayer.py:177-204, the
Tacotron-2 ``PostNet`` at text2vec/subLayer.py:240-302), kept so that a fork
which wires them up finds them.

Layout ``[B, T, C]``; parameter names are the reference's
(``layer.fc1.linear_layer.weight``, ``convolutions.{i}.0.conv.weight``,
``convolutions.{i}.1.running_mean``).  Dropout follows the module's mode,
as the reference's does: a train-mode forward draws from torch's generator.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Conv1d, Linear


class Prenet(nn.Module):
    """fc -> ReLU -> dropout -> fc -> ReLU -> dropout (p 0.5 in ``Prenet``,
    configurable in ``PreNet``: one module covers both)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, p: float = 0.5,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.layer = nn.Sequential(OrderedDict([
            ("fc1", Linear(input_size, hidden_size, device=device)),
            ("relu1", nn.ReLU()),
            ("dropout1", nn.Dropout(p)),
            ("fc2", Linear(hidden_size, output_size, device=device)),
            ("relu2", nn.ReLU()),
            ("dropout2", nn.Dropout(p)),
        ]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class ConvNorm(nn.Module):
    """The reference's ``ConvNorm``: a 'same' Conv1d, xavier-initialised with
    the gain of what follows it, under ``.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 w_init_gain: str = "linear", device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           padding=(kernel_size - 1) // 2, w_init_gain=w_init_gain,
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class PostNet(nn.Module):
    """Five k = 5 convolutions, each with BatchNorm: tanh after all but the
    last, dropout 0.5 after every one, the last included (subLayer.py:299),
    in train mode only."""

    def __init__(self, n_mel_channels: int = 80, postnet_embedding_dim: int = 512,
                 postnet_kernel_size: int = 5, postnet_n_convolutions: int = 5, device=None):
        super().__init__()
        device = resolve_device(device)
        self.convolutions = nn.ModuleList()
        for i in range(postnet_n_convolutions):
            last = i == postnet_n_convolutions - 1
            c_in = n_mel_channels if i == 0 else postnet_embedding_dim
            c_out = n_mel_channels if last else postnet_embedding_dim
            self.convolutions.append(nn.Sequential(
                ConvNorm(c_in, c_out, postnet_kernel_size,
                         w_init_gain="linear" if last else "tanh", device=device),
                BatchNorm(c_out, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, n_mel_channels] -> [B, T, n_mel_channels]"""
        for i, conv in enumerate(self.convolutions):
            x = conv(x)
            if i < len(self.convolutions) - 1:
                x = torch.tanh(x)
            x = F.dropout(x, 0.5, self.training)
        return x
