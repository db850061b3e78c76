"""One Text2Vec training step (JAX package: train/text2vec_train.py
``train_step``; reference: text2vec/train.py:199-455).

The step: the forward in train mode (BatchNorm on batch statistics,
dropout), ConvAttention soft alignment, MAS, durations and the hard-attention
expansion, the duration predictor, decoder and postnet; the 4-term loss
(``dnn_loss`` + ``binarization_loss_weight`` x binarization loss); the
backward; a clip to global norm ``grad_clip_thresh`` when ``(step + 1) %
grad_clip_every == 0``; the LAMB update; the BatchNorm running statistics
move during the forward.  A config with ``compute_dtype="bfloat16"`` builds
the model with bf16 compute (JAX: ``init_state``, text2vec_train.py:99); the
parameters, their gradients, the clip and the LAMB state stay f32.

In a process group (``parallel/mesh.py``) each rank steps on its local
batch, and the step computes what one process computes on the global batch
(JAX: ``make_train_step(mesh=...)``): the BatchNorms take global statistics;
the binarization loss divides by the global ``sum(hard)``
(``global_attention_binarization_loss``); the gradients are averaged over
the ranks before the clip, which then sees the global norm, and LAMB; the
reported losses are the ranks' means, the global batch's values.  The MSE
terms are plain means over padded elements, so they agree with the global
batch's only when every rank's batch has the same padded shape
(``data/dataset.py`` ``pad_to_max``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.losses import (
    dnn_loss,
    global_attention_binarization_loss,
)
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.parallel.mesh import all_reduce_mean, mean_scalars
from wavthruvec_pytorch_tpu_torch.text import pad_to_bucket
from wavthruvec_pytorch_tpu_torch.train.lamb import Lamb

# the scalars a step reports, in the JAX package's order
SCALAR_KEYS = ("total_loss", "WVF_loss", "WVF_postnet_loss", "duration_loss",
               "attn_binarization_loss")
# the validation losses, as the JAX package names them
VAL_KEYS = ("WVF_loss", "WVF_postnet_loss", "duration_loss", "binarization_loss")
BATCH_KEYS = ("text", "src_pos", "feat_target", "input_lengths", "output_lengths", "feat_pos",
              "attn_prior")


def make_padded_batch(items: Sequence[Dict], cfg: Text2VecConfig, text_pad: Optional[int] = None,
                      frame_pad: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pad host items ``{text_enc, feat_gt_target, attn_prior}`` into one
    batch of a bucketed shape (JAX package: ``make_padded_batch``): text to
    the smallest ``text_buckets`` entry that holds the longest text, frames
    likewise over ``frame_buckets``, unless ``text_pad``/``frame_pad`` say."""
    B = len(items)
    in_lens = np.array([len(it["text_enc"]) for it in items], np.int32)
    out_lens = np.array([it["feat_gt_target"].shape[0] for it in items], np.int32)
    N = text_pad or pad_to_bucket(int(in_lens.max()), cfg.text_buckets)
    T = frame_pad or pad_to_bucket(int(out_lens.max()), cfg.frame_buckets)
    text = np.zeros((B, N), np.int32)
    src_pos = np.zeros((B, N), np.int32)
    feat = np.zeros((B, T, cfg.n_feat_dim), np.float32)
    feat_pos = np.zeros((B, T), np.int32)
    prior = np.zeros((B, T, N), np.float32)
    for i, it in enumerate(items):
        n, t = in_lens[i], out_lens[i]
        text[i, :n] = it["text_enc"]
        src_pos[i, :n] = np.arange(1, n + 1)
        feat[i, :t] = it["feat_gt_target"]
        feat_pos[i, :t] = np.arange(1, t + 1)
        if it.get("attn_prior") is not None:
            prior[i, :t, :n] = it["attn_prior"]
    return {"text": text, "src_pos": src_pos, "feat_target": feat, "input_lengths": in_lens,
            "output_lengths": out_lens, "feat_pos": feat_pos, "attn_prior": prior}


def batch_to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's arrays of a batch (numpy arrays, or tensors such as
    ``DeviceResidentData.batch`` gives) as f32 and int64 tensors on
    ``device``; a tensor already there is used as it is."""
    out = {}
    for k in BATCH_KEYS:
        a = batch[k]
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        dtype = torch.float32 if a.is_floating_point() else torch.int64
        out[k] = a.to(device, dtype, non_blocking=True)
    return out


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: with ``n`` the global norm
    of ``grads``, leave them alone when ``n < max_norm``, else make each
    ``g / n * max_norm``.  Returns ``n``.  (``clip_grad_norm_`` would divide
    by ``n + 1e-6``.)  Reading ``n`` on the host syncs once."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    g_norm = torch.sqrt(torch.sum(norms * norms))
    if not bool(g_norm < max_norm):
        torch._foreach_div_(list(grads), g_norm)
        torch._foreach_mul_(list(grads), max_norm)
    return g_norm


class Text2VecTrainer:
    """A Text2Vec model in train mode, its LAMB optimizer and the step
    counter.  ``step(batch)`` runs one training step on a batch from
    ``make_padded_batch`` and returns the ``SCALAR_KEYS`` losses as 0-dim
    tensors on the device.  ``forward``, ``backward`` and
    ``apply_gradients`` are its three parts; ``validation_losses`` is the
    eval-mode forward, ``state_dict``/``load_state_dict`` what a checkpoint
    holds."""

    def __init__(self, cfg: Text2VecConfig, device=None, model: Optional[Text2Vec] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
            model = Text2Vec(cfg, device=self.device, dtype=dtype)
        self.model = model.train()
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Lamb(self.params, lr=cfg.learning_rate, betas=(cfg.beta1, cfg.beta2),
                              eps=cfg.epsilon, weight_decay=cfg.weight_decay)
        self.step_count = 0

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return batch_to_device(batch, self.device)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """-> (total loss, the SCALAR_KEYS losses, the model's outputs)."""
        out = self.model(batch["text"], batch["src_pos"], batch["feat_target"],
                         batch["input_lengths"], batch["output_lengths"], batch["feat_pos"],
                         attn_prior=batch["attn_prior"])
        wvf, postnet, duration = dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                          batch["feat_target"], out["duration_predictor_output"],
                                          out["duration"])
        binarization = global_attention_binarization_loss(out["attn"], out["attn_soft"])
        total = wvf + postnet + duration + self.cfg.binarization_loss_weight * binarization
        metrics = mean_scalars({k: v.detach() for k, v in zip(
            SCALAR_KEYS, (total, wvf, postnet, duration, binarization))})
        return total, metrics, out

    def backward(self, total: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()

    def apply_gradients(self) -> None:
        """Average the gradients over the ranks of a process group, clip on
        every ``grad_clip_every``-th step, then the LAMB update."""
        grads = [p.grad for p in self.params if p.grad is not None]
        all_reduce_mean(grads)
        if (self.step_count + 1) % self.cfg.grad_clip_every == 0:
            clip_by_global_norm(grads, self.cfg.grad_clip_thresh)
        self.optimizer.step()
        self.step_count += 1

    def step(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        total, metrics, _ = self.forward(self.to_device(batch))
        self.backward(total)
        self.apply_gradients()
        return metrics

    @torch.no_grad()
    def validation_losses(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The eval-mode forward (BatchNorm on its running statistics, no
        dropout) and its four losses ``VAL_KEYS`` as 0-dim tensors (JAX
        package: text2vec_loop.py ``make_val_fn``).  The model returns to
        train mode after it."""
        self.model.eval()
        try:
            _, metrics, _ = self.forward(self.to_device(batch))
        finally:
            self.model.train()
        return dict(zip(VAL_KEYS, (metrics["WVF_loss"], metrics["WVF_postnet_loss"],
                                   metrics["duration_loss"], metrics["attn_binarization_loss"])))

    @property
    def learning_rate(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def set_learning_rate(self, lr: float) -> None:
        """The frozen-lr mode (JAX: ``set_learning_rate``; reference:
        optimizer.py:29-35, train.py:378-380)."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def state_dict(self) -> Dict[str, object]:
        """The model's state dict (BatchNorm statistics included), LAMB's
        (its moments keyed by the index of each of ``params``) and the step
        count, which sets the clip's phase."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step_count": self.step_count}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Load what ``state_dict`` returned (tensors on any device)."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step_count = int(state["step_count"])
