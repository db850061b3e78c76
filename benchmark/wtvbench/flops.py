"""The operations of one request or one training step, as the reference
performs them at the cell's shapes: matmuls, convolutions, the dense
attention, the recurrence as its matmuls, forward and backward.  Counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device, so the
count is the same whatever implements the work, and nothing runs."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import text2vec as ref_t2v
from reference import vocoder as ref_voc
from reference.ops import Ops

META = torch.device("meta")


def _params(shapes: dict, grad: bool = False) -> dict:
    out = {}
    for k, s in shapes.items():
        dtype = torch.long if k.endswith("num_batches_tracked") else torch.float32
        t = torch.empty(s, dtype=dtype, device=META)
        out[k] = t.requires_grad_(grad and dtype == torch.float32)
    return out


def serve_item(tcfg: dict, vcfg: dict, n_text: int, max_frames: int) -> float:
    """One request padded to ``n_text`` tokens and ``max_frames`` frames:
    Text2Vec inference and the Generator."""
    P = _params(ref_t2v.param_shapes(tcfg))
    G = _params(ref_voc.generator_shapes(vcfg))
    ids = torch.ones((1, n_text), dtype=torch.long, device=META)
    spk = torch.empty((1, tcfg["n_speaker_dim"]), device=META)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        out = ref_t2v.infer(P, ids, spk, max_frames, tcfg, Ops(remat=False))
        ref_voc.generator(G, out["latents"], torch.empty((1, vcfg["spk_dim"]), device=META),
                          torch.empty((1, vcfg["noise_dim"]), device=META), vcfg, False, Ops(remat=False), {})
    return float(fc.get_total_flops())


def t2v_step(tcfg: dict, B: int, N: int, T: int) -> float:
    P = _params(ref_t2v.param_shapes(tcfg), grad=True)
    trained = [v for k, v in P.items() if ref_t2v.is_trained(k) and v.requires_grad]
    lens = torch.full((B,), N, dtype=torch.long, device=META)
    frames = torch.full((B,), T, dtype=torch.long, device=META)
    batch = {"text": torch.ones((B, N), dtype=torch.long, device=META),
             "src_pos": torch.ones((B, N), dtype=torch.long, device=META),
             "feat_target": torch.empty((B, T, tcfg["n_feat_dim"]), device=META),
             "input_lengths": lens, "output_lengths": frames,
             "feat_pos": torch.ones((B, T), dtype=torch.long, device=META),
             "attn_prior": torch.empty((B, T, N), device=META)}
    with FlopCounterMode(display=False) as fc:
        loss = ref_t2v.train_losses(P, batch, tcfg, Ops(remat=False))["total_loss"]
        torch.autograd.grad(loss, trained, allow_unused=True)
    return float(fc.get_total_flops())


def gan_step(vcfg: dict, B: int, T: int) -> float:
    """The Generator forward, the D step's discriminators forward and
    backward, the G step's discriminators forward and the backward into the
    Generator."""
    G = _params(ref_voc.generator_shapes(vcfg), grad=True)
    D1 = _params(ref_voc.mpd_shapes(vcfg), grad=True)
    D2 = _params(ref_voc.msd_shapes(vcfg), grad=True)
    up = 1
    for u in vcfg["upsample_rates"]:
        up *= u
    y = torch.empty((B, T * up), device=META)
    ops = Ops(remat=False)

    def trainable(P):
        return [v for k, v in P.items() if v.requires_grad and not (
            k.endswith(("weight_u", "weight_v")) and v.dim() == 1)]

    with FlopCounterMode(display=False) as fc:
        y_hat = ref_voc.generator(G, torch.empty((B, T, vcfg["n_feat_dim"]), device=META),
                                  torch.empty((B, vcfg["spk_dim"]), device=META),
                                  torch.empty((B, vcfg["noise_dim"]), device=META),
                                  vcfg, True, ops, {})
        r1, f1, _, _ = ref_voc.pair(lambda w: ref_voc.mpd(D1, w, vcfg, ops), y, y_hat.detach())
        r2, f2, _, _ = ref_voc.pair(lambda w: ref_voc.msd(D2, w, True, ops, {}), y, y_hat.detach())
        d = ref_voc.d_loss(r1, f1) + ref_voc.d_loss(r2, f2)
        torch.autograd.grad(d, trainable(D1) + trainable(D2), allow_unused=True)
        _, f1, fr1, fg1 = ref_voc.pair(lambda w: ref_voc.mpd(D1, w, vcfg, ops), y, y_hat)
        _, f2, fr2, fg2 = ref_voc.pair(lambda w: ref_voc.msd(D2, w, True, ops, {}), y, y_hat)
        g = (ref_voc.g_adv_loss(f1) + ref_voc.g_adv_loss(f2) + ref_voc.fm_loss(fr1, fg1)
             + ref_voc.fm_loss(fr2, fg2) + ref_voc.log_mel(y_hat, vcfg).abs().mean())
        torch.autograd.grad(g, trainable(G), allow_unused=True)
    return float(fc.get_total_flops())
