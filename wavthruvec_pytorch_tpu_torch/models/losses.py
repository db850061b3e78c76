"""Text2Vec training losses (JAX package: models/losses.py; reference:
text2vec/loss.py:7-54)."""

from __future__ import annotations

from typing import Tuple

import torch


def dnn_loss(feat_output: torch.Tensor, feat_postnet: torch.Tensor, feat_target: torch.Tensor,
             duration_predicted: torch.Tensor, duration_target: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MSE(feat, target), MSE(postnet, target), MSE(duration, target).

    Plain means over every padded element, as the reference's
    ``nn.MSELoss`` takes them: outputs are zero-masked and targets
    zero-padded."""
    wvf_loss = torch.mean((feat_output - feat_target) ** 2)
    postnet_loss = torch.mean((feat_postnet - feat_target) ** 2)
    duration_loss = torch.mean((duration_predicted - duration_target.to(torch.float32)) ** 2)
    return wvf_loss, postnet_loss, duration_loss


def attention_binarization_loss(hard_attention: torch.Tensor, soft_attention: torch.Tensor,
                                eps: float = 1e-12) -> torch.Tensor:
    """-sum(log soft[hard == 1]) / sum(hard); ``eps`` clips the soft
    attention below so that an underflowed cell gives a finite loss."""
    log_sum = torch.sum(torch.where(hard_attention == 1,
                                    torch.log(torch.clamp(soft_attention, min=eps)), 0.0))
    return -log_sum / torch.clamp(torch.sum(hard_attention), min=1.0)
