"""Duration predictor (JAX package: models/duration.py; reference:
text2vec/module.py:110-156): 2 x (Conv1d k=3 pad=1 -> LayerNorm -> ReLU ->
Dropout) -> Linear -> ReLU; dropout is the identity in eval mode.  ``dtype``
is the convolutions' compute dtype; as in the JAX package the LayerNorms
and the Linear have none, so the output is f32."""

from __future__ import annotations

import torch
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import Conv1d, LayerNorm, Linear, PartialConv1d


class ConvNorm(nn.Module):
    """The reference's ConvNorm wrapper: a Conv1d kept under ``.conv``, or a
    ``PartialConv1d`` with ``use_partial_padding`` (module.py:420-453)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 padding: int = 0, w_init_gain: str = "linear", dtype=None, device=None,
                 use_partial_padding: bool = False):
        super().__init__()
        if use_partial_padding:
            self.conv = PartialConv1d(in_channels, out_channels, kernel_size, padding=padding,
                                      w_init_gain=w_init_gain, device=device)
        else:
            self.conv = Conv1d(in_channels, out_channels, kernel_size, padding=padding,
                               w_init_gain=w_init_gain, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DurationPredictor(nn.Module):
    def __init__(self, in_dim: int, filter_size: int = 256, kernel_size: int = 3,
                 dropout: float = 0.1, dtype=None, device=None):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": ConvNorm(in_dim, filter_size, kernel_size, padding=1, dtype=dtype,
                                 device=device),
            "layer_norm_1": LayerNorm(filter_size, device=device),
            "conv1d_2": ConvNorm(filter_size, filter_size, kernel_size, padding=1, dtype=dtype,
                                 device=device),
            "layer_norm_2": LayerNorm(filter_size, device=device),
        })
        self.linear_layer = Linear(filter_size, 1, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, C] encoder output -> [B, N] non-negative durations (float)."""
        for i in (1, 2):
            x = self.conv_layer[f"conv1d_{i}"](x)
            x = self.dropout(torch.relu(self.conv_layer[f"layer_norm_{i}"](x)))
        return torch.relu(self.linear_layer(x))[..., 0]
