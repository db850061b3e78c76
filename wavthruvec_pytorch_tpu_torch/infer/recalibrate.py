"""BatchNorm running-statistics recalibration of a long-trained checkpoint
(JAX package: infer/recalibrate.py).

Why: LAMB's trust ratio lets the scale-invariant weights in front of a
BatchNorm grow without bound (train-mode BatchNorm renormalises every batch,
so the loss never sees it), and a long-trained checkpoint's eval-mode
BatchNorm, the serving path, can then amplify an outlier input until f32
overflows.  The fix leaves the training math as it is: forward calibration
batches with the BatchNorms on batch statistics and store the average of
the batches' moments as the running statistics.

How, as the JAX package does it: before each batch the running statistics
are set to 0, so that after it they hold ``(1 - momentum)`` times that
batch's moments (flax's update, ``models/layers.BatchNorm``); their sum over
the batches, divided by ``(1 - momentum) * n``, is the population average,
independent of the batches' order.  ``momentum`` is read from the port's
``BatchNorm``, whose running variance is the biased one.

The functions update the module they are given in place (its parameters,
``num_batches_tracked`` and everything but the BatchNorms' running means
and variances stay as they were) and return it.  The Generator's spectral
norm vectors ``u``/``v`` are put back after every batch: JAX runs the
calibration forward in train mode, whose power iteration sets sigma, and
throws the vectors' update away.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, _SpectralNorm
from wavthruvec_pytorch_tpu_torch.text import pad_to_bucket


def _bn_momentum() -> float:
    """The running-statistics momentum of every BatchNorm of the port."""
    return float(BatchNorm.momentum)


def _population_average(model: nn.Module, collect: Callable[[object], None],
                        batches: Iterable, momentum: Optional[float] = None) -> nn.Module:
    """Set every ``BatchNorm`` of ``model`` to the average of the pure
    per-batch moments over ``batches``; ``collect(batch)`` runs ``model`` with
    its BatchNorms on batch statistics."""
    if momentum is None:
        momentum = _bn_momentum()
    bns: List[BatchNorm] = [m for m in model.modules() if isinstance(m, BatchNorm)]
    counts = [bn.num_batches_tracked.clone() for bn in bns]
    acc = None
    n = 0
    with torch.no_grad():
        for batch in batches:
            for bn in bns:
                bn.running_mean.zero_()
                bn.running_var.zero_()
            collect(batch)
            stats = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
            acc = stats if acc is None else [(a + m, b + v) for (a, b), (m, v) in zip(acc, stats)]
            n += 1
        if n == 0:
            raise ValueError("recalibration needs at least one calibration batch")
        scale = 1.0 / ((1.0 - momentum) * n)
        for bn, (mean, var), count in zip(bns, acc, counts):
            bn.running_mean.copy_(mean * scale)
            bn.running_var.copy_(var * scale)
            bn.num_batches_tracked.copy_(count)
    return model


def recalibrate_text2vec_bn(t2v, batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                            max_frames: int, alpha: float = 1.0,
                            momentum: Optional[float] = None):
    """Refresh a ``Text2Vec``'s BatchNorm statistics (ECAPA and the CBHG).

    ``batches``: ``(src_seq [B, N] int, src_pos [B, N] int, wav_feat [B, T,
    n_feat])``: texts and speaker-reference clips, run through ``infer`` with
    ``train_bn=True``, so that ECAPA sees the serving inputs and the CBHG the
    model's own decoder outputs.  Dropout stays off."""
    dev = next(t2v.parameters()).device

    def collect(batch):
        seq, pos, feat = batch
        t2v.infer(torch.as_tensor(seq, dtype=torch.int64, device=dev),
                  torch.as_tensor(pos, dtype=torch.int64, device=dev),
                  torch.as_tensor(feat, dtype=torch.float32, device=dev), max_frames, alpha,
                  train_bn=True)

    return _population_average(t2v, collect, batches, momentum)


def recalibrate_generator_bn(gen, batches: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                             momentum: Optional[float] = None):
    """Refresh a ``Generator``'s Conditional BatchNorm statistics.

    ``batches``: ``(latents [B, T, n_feat], spk_emb [B, spk_dim], noise [B,
    noise_dim])``.  The forward runs in train mode (BatchNorm on batch
    statistics, one power iteration of each spectral norm), under
    ``torch.inference_mode()``; a ``fused`` Generator launches its fused
    ResBlock2 unit.  The spectral vectors are put back after each batch and
    the module's mode at the end."""
    dev = next(gen.parameters()).device
    spectral = [m for m in gen.modules() if isinstance(m, _SpectralNorm)]
    saved = [(m.weight_u.clone(), m.weight_v.clone()) for m in spectral]

    def restore_vectors():
        for m, (u, v) in zip(spectral, saved):
            m.weight_u.copy_(u)
            m.weight_v.copy_(v)

    def collect(batch):
        latents, spk, noise = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                               for a in batch)
        with torch.inference_mode():
            gen(latents, spk, noise)
            restore_vectors()

    was_training = gen.training
    gen.train()
    try:
        return _population_average(gen, collect, batches, momentum)
    finally:
        gen.train(was_training)
        with torch.no_grad():
            restore_vectors()


def text2vec_calibration_batches(frontend, cfg, items: Sequence[Tuple[str, np.ndarray]],
                                 batch_size: int = 8):
    """``(src_seq, src_pos, wav_feat)`` calibration batches from ``(text,
    ref_feat [T, n_feat])`` items (e.g. filelist rows), the texts padded to
    the config's text buckets and the clips to the batch's longest."""
    out = []
    for i in range(0, len(items), batch_size):
        chunk = items[i: i + batch_size]
        texts = [t for t, _ in chunk]
        feats = [f for _, f in chunk]
        ids, _ = frontend.encode_batch(
            texts, pad_to=pad_to_bucket(max(len(frontend.text_to_sequence(t)) for t in texts),
                                        cfg.text_buckets))
        src_pos = np.where(ids != 0, np.arange(1, ids.shape[1] + 1)[None], 0)
        wav = np.zeros((len(feats), max(f.shape[0] for f in feats), cfg.n_feat_dim), np.float32)
        for j, f in enumerate(feats):
            wav[j, : f.shape[0]] = f
        out.append((ids.astype(np.int32), src_pos.astype(np.int32), wav))
    return out
