"""Feed-Forward Transformer block: dense multi-head self-attention + conv FFN
(JAX package: models/fft_block.py; reference: text2vec/subLayer.py:34-174).

Keys are masked with -1e9 before the softmax; the FFN is Conv1d(k=9,
pad=4) -> ReLU -> Conv1d(k=1); each sublayer ends in LayerNorm(out +
residual) and the non-pad mask.  Dropout sits where the JAX package has it
(fft_block.py:146, 158, 189): on the attention probabilities, after ``fc``
and after ``w_2``; it is the identity in eval mode.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import Conv1d, LayerNorm

_MASK_VALUE = -1e9


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        qkv_std = math.sqrt(2.0 / (d_model + d_k))
        self.w_qs = nn.Linear(d_model, n_head * d_k, device=device)
        self.w_ks = nn.Linear(d_model, n_head * d_k, device=device)
        self.w_vs = nn.Linear(d_model, n_head * d_v, device=device)
        for lin in (self.w_qs, self.w_ks, self.w_vs):
            nn.init.normal_(lin.weight, 0.0, qkv_std)
        self.layer_norm = LayerNorm(d_model, device=device)
        self.fc = nn.Linear(n_head * d_v, d_model, device=device)
        nn.init.xavier_normal_(self.fc.weight)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, d_model], mask [B, T, T] bool (True at pad keys) ->
        ([B, T, d_model], attention probabilities [B, n_head, T, T])."""
        B, T, _ = x.shape
        q = self.w_qs(x).view(B, T, self.n_head, self.d_k)
        k = self.w_ks(x).view(B, T, self.n_head, self.d_k)
        v = self.w_vs(x).view(B, T, self.n_head, self.d_v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.d_k)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None], _MASK_VALUE)
        attn = self.dropout(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, self.n_head * self.d_v)
        out = self.layer_norm(self.dropout(self.fc(out)) + x)
        return out, attn


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, kernel: Tuple[int, int] = (9, 1),
                 padding: Tuple[int, int] = (4, 0), dropout: float = 0.1, device=None):
        super().__init__()
        self.w_1 = Conv1d(d_in, d_hid, kernel[0], padding=padding[0], device=device)
        self.w_2 = Conv1d(d_hid, d_in, kernel[1], padding=padding[1], device=device)
        self.layer_norm = LayerNorm(d_in, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dropout(self.w_2(torch.relu(self.w_1(x))))
        return self.layer_norm(out + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int, d_v: int,
                 fft_conv1d_kernel: Tuple[int, int] = (9, 1),
                 fft_conv1d_padding: Tuple[int, int] = (4, 0), dropout: float = 0.1,
                 device=None):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout, device=device)
        self.pos_ffn = PositionwiseFeedForward(
            d_model, d_inner, kernel=fft_conv1d_kernel, padding=fft_conv1d_padding,
            dropout=dropout, device=device)

    def forward(self, x: torch.Tensor, non_pad_mask: Optional[torch.Tensor] = None,
                slf_attn_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        out, attn = self.slf_attn(x, mask=slf_attn_mask)
        if non_pad_mask is not None:
            out = out * non_pad_mask
        out = self.pos_ffn(out)
        if non_pad_mask is not None:
            out = out * non_pad_mask
        return out, attn
