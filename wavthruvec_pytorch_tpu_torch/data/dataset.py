"""Text2Vec training data: every item in host memory, batched by length
(JAX package: data/dataset.py ``load_buffer``, ``BucketedLoader``;
reference: text2vec/dataset.py:57-214).

Each epoch shuffles the items, takes ``batch_size * batch_expand_size`` at a
time, sorts them by text length, longest first, and cuts them into
``batch_expand_size`` batches, each padded to the config's
(``text_buckets``, ``frame_buckets``) shape.

Under data parallelism (``parallel/mesh.py``) each rank loads its own
share of the file lists (``process_shard``) and batches ``batch_size``
items of it, its share of the global batch; ``pad_to_max`` then pads every
batch to the largest bucket pair, since the ranks' j-th batches must have
one shape and their bucket picks could differ.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.data import native_io
from wavthruvec_pytorch_tpu_torch.data.prior import get_attention_prior
from wavthruvec_pytorch_tpu_torch.parallel.mesh import process_shard, world_size
from wavthruvec_pytorch_tpu_torch.text import TextFrontend, pad_to_bucket
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import make_padded_batch


def load_buffer(file_lists: Sequence[str], cfg: Text2VecConfig,
                frontend: TextFrontend) -> List[Dict]:
    """Load every ``npy|text|speaker`` line of the file lists (feature paths
    relative to ``cfg.feat_ground_truth``): features ``[T, n_feat]``, text
    ids, and the cached attention prior; in a process group only this
    rank's share of the lines (``process_shard``).  The native prefetcher
    (``data/native_io.py``) reads the ``.npy`` files ahead of the parse
    loop on its threads."""
    lines: List[str] = []
    for path in file_lists:
        with open(path, "r", encoding="utf-8") as f:
            lines.extend(f.readlines())
    lines = process_shard(lines)
    parsed = [line.strip().split("|") for line in lines]
    paths = [os.path.join(cfg.feat_ground_truth, p[0]) for p in parsed]
    start = time.perf_counter()
    buffer = []
    with native_io.Prefetcher(paths) as prefetcher:
        feats = map(prefetcher.get, range(len(paths)))
        for (_, character, spk), feat_path, feat in zip(parsed, paths, feats):
            # [1, T, C] -> [T, C]
            feat = np.asarray(feat).squeeze().astype(np.float32, copy=False)
            text_enc = np.asarray(frontend.text_to_sequence(character), np.int32)
            prior = (get_attention_prior(text_enc.shape[0], feat.shape[0],
                                         cache_path=cfg.betabinom_cache_path,
                                         scaling_factor=cfg.betabinom_scaling_factor)
                     if cfg.use_attn_prior_masking else None)
            buffer.append({"text_enc": text_enc, "feat_gt_target": feat,
                           "audiopath": feat_path, "attn_prior": prior, "speaker": spk})
    print(f"cost {time.perf_counter() - start:.2f}s to load all data into buffer.")
    if buffer:
        _check_position_capacity(cfg, max(len(it["text_enc"]) for it in buffer),
                                 max(it["feat_gt_target"].shape[0] for it in buffer))
    return buffer


def _check_position_capacity(cfg: Text2VecConfig, max_text_len: int, max_frames: int) -> None:
    """Refuse data that the sinusoid position tables cannot index (JAX:
    ``Text2VecConfig.validate_position_capacity``): the model clamps
    positions, so longer data would train on aliased positions."""
    if max_text_len > cfg.vocab_size:
        raise ValueError(f"longest text ({max_text_len} tokens) exceeds the encoder position "
                         f"table (vocab_size={cfg.vocab_size}, text2vec/model.py:86)")
    if max_frames > cfg.max_seq_len:
        raise ValueError(f"longest feature sequence ({max_frames} frames) exceeds the decoder "
                         f"position table (max_seq_len={cfg.max_seq_len})")


class BucketedLoader:
    """Length-bucketed batches of ``batch_size`` items (default
    ``cfg.batch_size``; a rank's ``local_batch_size`` under data
    parallelism) over a buffer; ``shuffle=False`` keeps the buffer's order
    (the validation loader's, with ``batch_expand_size`` 1).  With
    ``pad_to_max`` (default: exactly when the world size is above 1) every
    batch is padded to the largest bucket pair."""

    def __init__(self, buffer: List[Dict], cfg: Text2VecConfig, seed: int = 0,
                 shuffle: bool = True, batch_size: Optional[int] = None,
                 pad_to_max: Optional[bool] = None):
        self.buffer = buffer
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.batch_size = batch_size or cfg.batch_size
        self.super_batch = self.batch_size * cfg.batch_expand_size
        self.pad_to_max = world_size() > 1 if pad_to_max is None else pad_to_max

    def __len__(self) -> int:
        return len(self.buffer) // self.super_batch * self.cfg.batch_expand_size

    def epoch_indices(self) -> Iterator[List[int]]:
        """Each batch's buffer indices, in the order ``epoch`` pads them
        (``data.device_cache.DeviceResidentData`` gathers the same batches
        on the card); one draw of the shuffle per call."""
        order = (self.rng.permutation(len(self.buffer)) if self.shuffle
                 else np.arange(len(self.buffer)))
        for s in range(len(order) // self.super_batch):
            idx = [int(i) for i in order[s * self.super_batch:(s + 1) * self.super_batch]]
            idx.sort(key=lambda i: -len(self.buffer[i]["text_enc"]))
            for j in range(self.cfg.batch_expand_size):
                yield idx[j * self.batch_size:(j + 1) * self.batch_size]

    def batch(self, idx: Sequence[int]) -> Dict[str, np.ndarray]:
        items = [self.buffer[i] for i in idx]
        if self.pad_to_max:
            return make_padded_batch(items, self.cfg, text_pad=self.cfg.text_buckets[-1],
                                     frame_pad=self.cfg.frame_buckets[-1])
        return make_padded_batch(items, self.cfg)

    def bucket_shapes(self) -> List[Tuple[int, int]]:
        """Every (text bucket, frame bucket) pair an item of the buffer falls
        in, sorted."""
        return sorted({(pad_to_bucket(len(it["text_enc"]), self.cfg.text_buckets),
                        pad_to_bucket(it["feat_gt_target"].shape[0], self.cfg.frame_buckets))
                       for it in self.buffer})

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        for idx in self.epoch_indices():
            yield self.batch(idx)
