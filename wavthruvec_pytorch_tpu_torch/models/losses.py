"""Text2Vec training losses (JAX package: models/losses.py; reference:
text2vec/loss.py:7-54)."""

from __future__ import annotations

from typing import Tuple

import torch

from wavthruvec_pytorch_tpu_torch.parallel.mesh import all_reduce_sum, world_size


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


def _hard_log_sum(hard_attention: torch.Tensor, soft_attention: torch.Tensor,
                  eps: float) -> torch.Tensor:
    return torch.sum(torch.where(hard_attention == 1,
                                 torch.log(torch.clamp(soft_attention, min=eps)), 0.0))


def attention_binarization_loss(hard_attention: torch.Tensor, soft_attention: torch.Tensor,
                                eps: float = 1e-12) -> torch.Tensor:
    """-sum(log soft[hard == 1]) / sum(hard); ``eps`` clips the soft
    attention below so that an underflowed cell gives a finite loss."""
    log_sum = _hard_log_sum(hard_attention, soft_attention, eps)
    return -log_sum / torch.clamp(torch.sum(hard_attention), min=1.0)


def global_attention_binarization_loss(hard_attention: torch.Tensor,
                                       soft_attention: torch.Tensor,
                                       eps: float = 1e-12) -> torch.Tensor:
    """This rank's term of the binarization loss over the global batch of a
    process group (``parallel/mesh.py``): ``-sum_r(log-sum) / max(sum_r(sum
    hard), 1)``, as JAX takes it over a sharded batch.  The denominator is
    summed over the ranks without a gradient, and each rank's numerator is
    scaled by the world size, so that the ranks' mean of these terms, and of
    their gradients, is the global loss and its gradient.  (The mean of the
    ranks' own ratios is another loss, whose error grows with the ranks'
    length imbalance.)"""
    count = all_reduce_sum(torch.sum(hard_attention).detach())
    log_sum = _hard_log_sum(hard_attention, soft_attention, eps)
    return -log_sum * float(world_size()) / torch.clamp(count, min=1.0)
