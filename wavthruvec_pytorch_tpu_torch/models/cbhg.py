"""CBHG postnet: conv bank -> maxpool -> projections -> highway -> BiGRU
(JAX package: models/cbhg.py; reference: text2vec/module.py:287-364).

The K=8 conv bank keeps the reference's per-k BatchNormConv1d (conv pad k//2,
no bias, ReLU, BN) with the [:T] slice for even kernels; maxpool(k=2, s=1,
pad=1) is sliced back to T.  The BiGRU runs the hand-written recurrence
kernel of ``gru_impl``'s numerics on the card (``ops/gru.py``).  ``dtype``
is the convolutions' compute dtype; as in the JAX package the BatchNorms,
the highways and the BiGRU have none and compute in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, BiGRU, Conv1d, Highway


class BatchNormConv1d(nn.Module):
    """conv(bias=False, xavier) -> optional ReLU -> BN (reference:
    text2vec/module.py:159-176)."""

    def __init__(self, in_dim: int, out_dim: int, kernel_size: int, padding: int = 0,
                 activation: Optional[str] = None, dtype=None, device=None):
        super().__init__()
        self.conv1d = Conv1d(in_dim, out_dim, kernel_size, padding=padding, bias=False,
                             w_init_gain="linear", dtype=dtype, device=device)
        self.bn = BatchNorm(out_dim, device=device)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1d(x)
        if self.activation == "relu":
            x = F.relu(x)
        return self.bn(x)


class CBHG(nn.Module):
    """[B, T, in_dim] -> [B, T, 2 * in_dim], with projections (256, in_dim).
    ``gru_impl`` is the JAX package's: "scan" (its default, f32) or
    "pallas" (bf16 where JAX's Pallas gate admits the shape)."""

    def __init__(self, in_dim: int, K: int = 8, dtype=None, gru_impl: str = "scan", device=None):
        super().__init__()
        self.conv1d_banks = nn.ModuleList(
            BatchNormConv1d(in_dim, in_dim, k, padding=k // 2, activation="relu",
                            dtype=dtype, device=device)
            for k in range(1, K + 1))
        projections = (256, in_dim)
        in_sizes = (K * in_dim,) + projections[:-1]
        activations = ("relu", None)
        self.conv1d_projections = nn.ModuleList(
            BatchNormConv1d(i, o, 3, padding=1, activation=a, dtype=dtype, device=device)
            for i, o, a in zip(in_sizes, projections, activations))
        # The reference's pre_highway Linear(1024, in_dim) (module.py:312) is
        # dead weight: it is bypassed because projections[-1] == in_dim.  It
        # is kept so that reference-layout state dicts load strictly.
        self.pre_highway = nn.Linear(1024, in_dim, bias=False, device=device)
        self.highways = nn.ModuleList(Highway(in_dim, in_dim, device=device) for _ in range(4))
        self.gru = BiGRU(in_dim, in_dim, gru_impl=gru_impl, device=device)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        T = inputs.shape[1]
        x = torch.cat([conv(inputs)[:, :T] for conv in self.conv1d_banks], dim=-1)
        x = F.max_pool1d(x.transpose(1, 2), kernel_size=2, stride=1, padding=1)
        x = x[:, :, :T].transpose(1, 2)
        for conv in self.conv1d_projections:
            x = conv(x)
        x = x + inputs
        for highway in self.highways:
            x = highway(x)
        return self.gru(x)
