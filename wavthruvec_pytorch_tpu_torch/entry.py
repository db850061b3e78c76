"""End-to-end synthesis forward, text -> latents -> wav, as one function
(JAX package: ``__graft_entry__.entry``).

``entry()`` returns ``(fn, example_args)``: ``fn(*example_args)`` runs
``Text2Vec.infer`` and the ``Generator`` on seeded random weights and inputs
and returns ``(wav [B, max_frames * 320], total_frames [B])``.  The default
is the full-size configuration at batch 1 on the card; the CPU, other
configs and sizes are for tests.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator


def entry(device=None, t2v_cfg: Optional[Text2VecConfig] = None,
          v2w_cfg: Optional[Vec2WavConfig] = None, batch: int = 1, n_text: int = 32,
          max_frames: int = 256, ref_t: int = 128, seed: int = 0) -> Tuple[Callable, tuple]:
    """Build seeded random models and inputs; the last 8 text positions of
    each item are padding, as in the JAX entry."""
    device = resolve_device(device)
    t2v_cfg = t2v_cfg or Text2VecConfig()
    v2w_cfg = v2w_cfg or Vec2WavConfig()
    torch.manual_seed(seed)
    t2v = Text2Vec(t2v_cfg, device=device)
    gen = Generator(v2w_cfg, device=device)

    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pad = min(8, n_text - 1)
    src_seq = torch.cat([
        torch.randint(4, t2v_cfg.vocab_size, (batch, n_text - n_pad), generator=g),
        torch.zeros((batch, n_pad), dtype=torch.int64)], dim=1)
    src_pos = torch.where(src_seq != 0, torch.arange(1, n_text + 1)[None], 0)
    ref_feat = torch.randn((batch, ref_t, t2v_cfg.n_feat_dim), generator=g) * 0.1
    spk_emb = torch.randn((batch, v2w_cfg.spk_dim), generator=g)
    noise = torch.randn((batch, v2w_cfg.noise_dim), generator=g)
    args = tuple(a.to(device) for a in (src_seq, src_pos, ref_feat, spk_emb, noise))

    def fn(t2v, gen, src_seq, src_pos, ref_feat, spk_emb, noise):
        out = t2v.infer(src_seq, src_pos, ref_feat, max_frames, 1.0)
        wav = gen(out["feat_postnet_output"], spk_emb, noise)
        return wav[..., 0], out["total_frames"]

    return fn, (t2v, gen) + args
