"""The Text2Vec corpus staged on the card, batches gathered there (JAX
package: data/device_cache.py ``DeviceResidentData``).

The host path pads every batch on the host and copies it to the card each
step (``BucketedLoader.batch`` then ``Text2VecTrainer.to_device``): at
B = 16 x 1024 frames at text bucket 128 that is 72 MiB a step.  Here
the corpus crosses once, as flat ragged tensors with no length padding:

* ``flat_text [sum n]`` (int32), ``flat_feat [sum t, n_feat_dim]`` and
  ``flat_prior [sum t, N_cap]`` (f32), ``N_cap = text_buckets[-1]``, each
  with a zero tail of ``N_cap`` / ``T_cap`` rows so that a window that
  starts at the last item stays in range;
* each item's offsets and lengths, on the card and on the host.

A batch at the bucket pair (N_b, T_b) is one windowed gather per tensor: a
window of N_b text ids and T_b frames from each item's offset, zeroed past
the item's lengths (the window runs into the next item), with the positions
``1..n`` computed on the card.  The bucket pair is chosen on the host from
the host copy of the lengths, exactly as the host collate chooses it
(``pad_to_bucket`` over the batch's longest text and frames), so the only
thing that crosses to the card a step is the ``[B]`` index vector.  The
batches equal ``make_padded_batch``'s, moved to the card as
``Text2VecTrainer.to_device`` moves them (int64 ids, f32 features), bit for
bit.  Under data parallelism each rank stages its own share of the corpus
(``load_buffer`` reads only that) on its own card, and ``batch(idx,
pad_to_max=True)`` gathers at the largest bucket pair, as the loader pads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.text import pad_to_bucket

# the share of the card's memory a staged corpus may take
BUDGET_SHARE = 0.8


def device_memory_bytes(device: torch.device) -> Optional[int]:
    """The card's memory (``torch.cuda.mem_get_info``'s total); None on the
    CPU, which sets no budget."""
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def check_budget(est: int, device: torch.device, what: str) -> None:
    """Raise a ``ValueError`` giving the size in GiB, before anything is
    allocated, when ``est`` bytes pass ``BUDGET_SHARE`` of the card's
    memory (the JAX package: 80% of ``bytes_limit``)."""
    limit = device_memory_bytes(device)
    if limit is not None and est > BUDGET_SHARE * limit:
        raise ValueError(
            f"device_resident_data: staging {what} needs ~{est / 2**30:.1f} GiB of the card's "
            f"{limit / 2**30:.1f} GiB (budget {BUDGET_SHARE:.0%}); use the host data path "
            "(device_resident_data=False) or a smaller corpus.")


def to_card(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


class DeviceResidentData:
    """A Text2Vec buffer (``data.dataset.load_buffer``) staged on ``device``
    (the card unless the caller passes ``"cpu"``), and its batches gathered
    there.  An item past the largest buckets is refused with a
    ``ValueError``, as the host collate refuses it."""

    def __init__(self, buffer: List[Dict], cfg: Text2VecConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        n = len(buffer)
        N_cap = self.N_cap = cfg.text_buckets[-1]
        T_cap = self.T_cap = cfg.frame_buckets[-1]
        in_lens = np.array([len(it["text_enc"]) for it in buffer], np.int64)
        out_lens = np.array([it["feat_gt_target"].shape[0] for it in buffer], np.int64)
        for what, lens, cap, name in (("text ids", in_lens, N_cap, "text_buckets"),
                                      ("frames", out_lens, T_cap, "frame_buckets")):
            if n and lens.max() > cap:
                raise ValueError(f"device_resident_data: item {int(lens.argmax())} has "
                                 f"{int(lens.max())} {what}, past the largest of {name} "
                                 f"({cap})")
        sum_n, sum_t = int(in_lens.sum()), int(out_lens.sum())
        # the JAX package's estimate: the flat tensors below
        check_budget((sum_t + T_cap) * (cfg.n_feat_dim + N_cap) * 4 + (sum_n + N_cap) * 4,
                     self.device, f"{n} items")
        self.in_lens_host, self.out_lens_host = in_lens, out_lens
        text_off = np.concatenate([[0], np.cumsum(in_lens)[:-1]]).astype(np.int64)
        feat_off = np.concatenate([[0], np.cumsum(out_lens)[:-1]]).astype(np.int64)

        flat_text = np.zeros(sum_n + N_cap, np.int32)
        flat_feat = np.zeros((sum_t + T_cap, cfg.n_feat_dim), np.float32)
        flat_prior = np.zeros((sum_t + T_cap, N_cap), np.float32)
        for i, it in enumerate(buffer):
            tn, tt, to, fo = in_lens[i], out_lens[i], text_off[i], feat_off[i]
            flat_text[to:to + tn] = it["text_enc"]
            flat_feat[fo:fo + tt] = it["feat_gt_target"]
            if it.get("attn_prior") is not None:
                flat_prior[fo:fo + tt, :tn] = it["attn_prior"]
        self.audiopaths = [it.get("audiopath", "") for it in buffer]
        dev = self.device
        self.flat_text = to_card(flat_text, dev)
        self.flat_feat = to_card(flat_feat, dev)
        del flat_feat
        self.flat_prior = to_card(flat_prior, dev)
        del flat_prior
        self.text_off, self.feat_off = to_card(text_off, dev), to_card(feat_off, dev)
        self.in_lens, self.out_lens = to_card(in_lens, dev), to_card(out_lens, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def nbytes(self) -> int:
        """Bytes staged on the card."""
        return sum(t.numel() * t.element_size() for t in (
            self.flat_text, self.flat_feat, self.flat_prior, self.text_off, self.feat_off,
            self.in_lens, self.out_lens))

    def batch(self, idx: Sequence[int], pad_to_max: bool = False) -> Dict[str, torch.Tensor]:
        """The batch of buffer items ``idx`` gathered on the card, the keys
        of ``make_padded_batch`` as ``Text2VecTrainer.to_device`` gives
        them; only ``idx`` crosses to the card.  Its bucket pair comes from
        the host copy of the lengths: the smallest configured pair that
        holds the batch, or with ``pad_to_max`` the largest,
        ``(N_cap, T_cap)`` (``BucketedLoader.pad_to_max``)."""
        idx = np.asarray(idx, np.int64)
        if pad_to_max:
            N_b, T_b = self.N_cap, self.T_cap
        else:
            N_b = pad_to_bucket(int(self.in_lens_host[idx].max()), self.cfg.text_buckets)
            T_b = pad_to_bucket(int(self.out_lens_host[idx].max()), self.cfg.frame_buckets)
        dev = self.device
        i = torch.as_tensor(idx).to(dev, non_blocking=True)
        il, ol = self.in_lens[i], self.out_lens[i]
        ar_n = torch.arange(N_b, device=dev)
        ar_t = torch.arange(T_b, device=dev)
        nmask = ar_n[None] < il[:, None]                    # [B, N_b]
        tmask = ar_t[None] < ol[:, None]                    # [B, T_b]
        rows = self.feat_off[i][:, None] + ar_t[None]       # [B, T_b]
        text = self.flat_text[self.text_off[i][:, None] + ar_n[None]].long()
        # the prior's staged rows are zero past each item's n <= N_b, so
        # the column window loses nothing; the row mask zeroes the overrun
        zero = torch.zeros((), device=dev)
        return {
            "text": torch.where(nmask, text, 0),
            "src_pos": torch.where(nmask, ar_n[None] + 1, 0),
            "feat_target": torch.where(tmask[..., None], self.flat_feat[rows], zero),
            "input_lengths": il,
            "output_lengths": ol,
            "feat_pos": torch.where(tmask, ar_t[None] + 1, 0),
            "attn_prior": torch.where(tmask[..., None], self.flat_prior[rows, :N_b], zero),
        }

    def batch_audiopaths(self, idx: Sequence[int]) -> List[str]:
        return [self.audiopaths[int(i)] for i in idx]
