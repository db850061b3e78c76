"""Feed-Forward Transformer block: dense multi-head self-attention + conv FFN
(JAX package: models/fft_block.py; reference: text2vec/subLayer.py:34-174).

Keys are masked with -1e9 before the softmax; the FFN is Conv1d(k=9,
pad=4) -> ReLU -> Conv1d(k=1); each sublayer ends in LayerNorm(out +
residual) and the non-pad mask.  Dropout sits where the JAX package has it
(fft_block.py:146, 158, 189): on the attention probabilities, after ``fc``
and after ``w_2``; it is the identity in eval mode.

``dtype`` is the projections', convolutions' and LayerNorms' compute dtype
(``models/layers.py``); the dense branch's scores, softmax and ``attn @ v``
are f32 whatever it is (JAX: ``preferred_element_type=jnp.float32``).

``use_flash`` takes JAX's flash branch (fft_block.py:99-136) where JAX's gate
passes, with the device test left out: ``d_v == d_k``, ``T % 128 == 0`` and
``T >= 256``.  It runs ``ops.flash_attention`` (the CUDA kernels on the card,
the plain version on the CPU) with segment ids 1 at real and 0 at pad
positions: real queries see real keys, as in the dense branch, and pad
queries see pad keys, rows the block's non-pad mask zeroes.  It keeps no
probabilities (``attn`` is ``[B, H, 0, 0]``) and cannot drop them out, so a
training forward with ``use_flash`` and dropout > 0 raises, gate or not.
Both devices take every head dim, as JAX's flash branch does: the kernels
run d_k up to 256 on their templates and past it on the wide kernels
(``ops/flash_attention.py``), the CPU the plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import Conv1d, LayerNorm, TorchLinear
from wavthruvec_pytorch_tpu_torch.ops.flash_attention import flash_attention

_MASK_VALUE = -1e9


def flash_gate(use_flash: bool, d_k: int, d_v: int, T: int) -> bool:
    """JAX's flash gate (fft_block.py:99-105) without its TPU test."""
    return use_flash and d_v == d_k and T % 128 == 0 and T >= 256


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.1,
                 use_flash: bool = False, dtype=None, device=None):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.use_flash = use_flash
        qkv_std = math.sqrt(2.0 / (d_model + d_k))
        self.w_qs = TorchLinear(d_model, n_head * d_k, dtype=dtype, device=device)
        self.w_ks = TorchLinear(d_model, n_head * d_k, dtype=dtype, device=device)
        self.w_vs = TorchLinear(d_model, n_head * d_v, dtype=dtype, device=device)
        for lin in (self.w_qs, self.w_ks, self.w_vs):
            nn.init.normal_(lin.weight, 0.0, qkv_std)
        self.layer_norm = LayerNorm(d_model, dtype=dtype, device=device)
        self.fc = TorchLinear(n_head * d_v, d_model, dtype=dtype, device=device)
        nn.init.xavier_normal_(self.fc.weight)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, d_model], mask [B, T, T] bool (True at pad keys) ->
        ([B, T, d_model], attention probabilities [B, n_head, T, T], or
        ``[B, n_head, 0, 0]`` from the flash branch)."""
        if self.use_flash and self.training and self.dropout.p > 0:
            raise ValueError(
                "flash_attention=True cannot apply attention-prob dropout "
                f"(dropout={self.dropout.p}) in a training forward; train with dropout=0.0 "
                "or without flash_attention (the JAX package raises the same, "
                "models/fft_block.py:88-98)")
        B, T, _ = x.shape
        q = self.w_qs(x).view(B, T, self.n_head, self.d_k)
        k = self.w_ks(x).view(B, T, self.n_head, self.d_k)
        v = self.w_vs(x).view(B, T, self.n_head, self.d_v)
        if flash_gate(self.use_flash, self.d_k, self.d_v, T):
            if mask is not None:
                seg = (~mask[:, 0, :]).to(torch.int32)  # 1 real, 0 pad
            else:
                seg = torch.ones(B, T, dtype=torch.int32, device=x.device)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), seg,
                                  1.0 / math.sqrt(self.d_k))
            out = out.transpose(1, 2).reshape(B, T, self.n_head * self.d_v)
            attn = x.new_zeros((B, self.n_head, 0, 0), dtype=torch.float32)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(self.d_k)
            if mask is not None:
                scores = scores.masked_fill(mask[:, None], _MASK_VALUE)
            attn = self.dropout(torch.softmax(scores, dim=-1))
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v.float())
            out = out.reshape(B, T, self.n_head * self.d_v)
        out = self.layer_norm(self.dropout(self.fc(out)) + x)
        return out, attn


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, kernel: Tuple[int, int] = (9, 1),
                 padding: Tuple[int, int] = (4, 0), dropout: float = 0.1, dtype=None,
                 device=None):
        super().__init__()
        self.w_1 = Conv1d(d_in, d_hid, kernel[0], padding=padding[0], dtype=dtype, device=device)
        self.w_2 = Conv1d(d_hid, d_in, kernel[1], padding=padding[1], dtype=dtype, device=device)
        self.layer_norm = LayerNorm(d_in, dtype=dtype, device=device)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.dropout(self.w_2(torch.relu(self.w_1(x))))
        return self.layer_norm(out + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int, d_v: int,
                 fft_conv1d_kernel: Tuple[int, int] = (9, 1),
                 fft_conv1d_padding: Tuple[int, int] = (4, 0), dropout: float = 0.1,
                 use_flash: bool = False, dtype=None, device=None):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout,
                                           use_flash=use_flash, dtype=dtype, device=device)
        self.pos_ffn = PositionwiseFeedForward(
            d_model, d_inner, kernel=fft_conv1d_kernel, padding=fft_conv1d_padding,
            dropout=dropout, dtype=dtype, device=device)

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
