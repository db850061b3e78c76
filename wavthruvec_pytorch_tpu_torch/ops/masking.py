"""Mask construction from lengths / position tensors (JAX package:
ops/masking.py; reference: text2vec/utils.py:10-123, text2vec/model.py:19-68)."""

from __future__ import annotations

import torch


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True at valid positions."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids < lengths[:, None].to(torch.int64)


def get_non_pad_mask(seq: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """[B, T] id tensor -> [B, T, 1] float mask, 1.0 at non-pad positions."""
    if seq.dim() != 2:
        raise ValueError(f"expected a [B, T] id tensor, got {tuple(seq.shape)}")
    return (seq != pad).to(torch.float32)[..., None]


def get_attn_key_pad_mask(seq_k: torch.Tensor, seq_q: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Key-padding mask for self attention: [B, len_q, len_k] bool, True at PAD keys."""
    len_q = seq_q.shape[1]
    padding_mask = (seq_k == pad)[:, None, :]
    return padding_mask.expand(seq_k.shape[0], len_q, seq_k.shape[1])


def positions_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """1-based position ids, 0 beyond length: [B, max_len] int64."""
    ids = torch.arange(1, max_len + 1, device=lengths.device)[None, :]
    valid = ids <= lengths[:, None].to(torch.int64)
    return torch.where(valid, ids, torch.zeros_like(ids))
