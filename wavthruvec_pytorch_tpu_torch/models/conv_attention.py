"""RAD-TTS ConvAttention: the soft alignment between text and frames
(JAX package: models/conv_attention.py; reference: text2vec/module.py:420-545).

The squared distance is expanded as ``|q|^2 + |k|^2 - 2 q.k``, as the JAX
package does, so the largest term is one batched matmul and nothing of
size [B, C, T1, T2] is made.  Kept from the reference: the hard-coded
temperature 0.0005 (module.py:522), log_softmax over the text dim plus
``log(prior + 1e-8)`` (module.py:535), the key mask at -1e9, then a softmax
over text (module.py:539-544).  The reference constructs it with two
arguments, so ``n_att_channels`` keeps its default 80.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.duration import ConvNorm
from wavthruvec_pytorch_tpu_torch.ops.masking import get_mask_from_lengths

_MASK_VALUE = -1e9
TEMPERATURE = 0.0005


class ConvAttention(nn.Module):
    """Parameter names are the reference's (``key_proj.{0,2}.conv``,
    ``query_proj.{0,2,4}.conv``).  ``use_partial_padding``
    (``attn_use_partial_padding``) makes every projection a
    ``PartialConv1d``, called without a mask as the JAX package calls it."""

    def __init__(self, n_feat_channels: int, n_text_channels: int,
                 n_att_channels: int = 80, use_partial_padding: bool = False, device=None):
        super().__init__()

        def conv(c_in, c_out, k, w_init_gain="linear"):
            return ConvNorm(c_in, c_out, k, padding=(k - 1) // 2, w_init_gain=w_init_gain,
                            use_partial_padding=use_partial_padding, device=device)

        self.key_proj = nn.Sequential(
            conv(n_text_channels, 2 * n_text_channels, 3, "relu"),
            nn.ReLU(),
            conv(2 * n_text_channels, n_att_channels, 1),
        )
        self.query_proj = nn.Sequential(
            conv(n_feat_channels, 2 * n_feat_channels, 3, "relu"),
            nn.ReLU(),
            conv(2 * n_feat_channels, n_feat_channels, 1),
            nn.ReLU(),
            conv(n_feat_channels, n_att_channels, 1),
        )

    def forward(self, queries: torch.Tensor, keys: torch.Tensor,
                key_lens: Optional[torch.Tensor] = None,
                attn_prior: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """queries [B, T1, n_feat] (frames), keys [B, T2, n_text] (text),
        key_lens [B], attn_prior [B, T1, T2] -> (attn [B, T1, T2], a softmax
        over T2, and attn_logprob [B, T1, T2])."""
        k = self.key_proj(keys)
        q = self.query_proj(queries)
        q_sq = torch.sum(q * q, dim=-1)[:, :, None]
        k_sq = torch.sum(k * k, dim=-1)[:, None, :]
        qk = torch.bmm(q, k.transpose(1, 2))
        attn = -TEMPERATURE * (q_sq + k_sq - 2.0 * qk)
        if attn_prior is not None:
            attn = F.log_softmax(attn, dim=2) + torch.log(attn_prior + 1e-8)
        attn_logprob = attn
        if key_lens is not None:
            key_mask = get_mask_from_lengths(key_lens, keys.shape[1])
            attn = attn.masked_fill(~key_mask[:, None, :], _MASK_VALUE)
        return torch.softmax(attn, dim=2), attn_logprob
