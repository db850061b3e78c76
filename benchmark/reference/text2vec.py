"""Plain Text2Vec in f32: FFT encoder with ECAPA-TDNN speaker conditioning,
duration predictor and length regulator, FFT decoder, CBHG postnet with a
BiGRU; for training the RAD-TTS soft alignment, monotonic alignment search,
the four losses and LAMB (WavThruVec, arXiv:2203.16930; FastSpeech,
arXiv:1905.09263; RAD-TTS, arXiv:2108.10447; ECAPA-TDNN, arXiv:2005.07143).

Parameters are a dict from the published implementation's state-dict names
(``p1an-lin-jung/WavThruVec_pytorch`` ``text2vec/model.py``) to tensors, so
that one seeded dict feeds both this reference and the program.  ``cfg`` is
the ``text2vec`` section of a configuration file.  Dropout is not modelled:
the configurations run it at 0 in training, and inference has none.

Semantics kept from the published code: position ids clamped at the table's
end; ``d_k = d_model // encoder_head`` in both stacks; keys masked at -1e9;
each FFT sublayer ends in LayerNorm(out + residual) and the non-pad mask;
the duration predictor ends in a ReLU; inference durations are ``floor(dp
+ 0.5)``, zero at pad tokens; the CBHG bank slices even kernels back to T
after their BatchNorm; the BiGRU runs over the whole padded length, its
reverse direction over the flipped sequence; the attention temperature is
0.0005 and the prior enters as ``log(prior + 1e-8)`` after a log-softmax.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .ops import Ops, batch_norm, conv_btc, layer_norm, sinusoid_table

NEG = -1e9
TEMPERATURE = 0.0005
ECAPA_SCALE = 8
ECAPA_LAYERS = ((3, 2), (3, 3), (3, 4))  # (kernel, dilation) of layer1..3
CBHG_K = 8
LOSS_KEYS = ("total_loss", "WVF_loss", "WVF_postnet_loss", "duration_loss",
             "attn_binarization_loss")


def _check(cfg: dict) -> None:
    for key, want in (("use_multi_speaker_condition", True), ("learn_alignments", True),
                      ("use_speaker_emb_for_alignment", True), ("input_wav", False),
                      ("attn_use_partial_padding", False)):
        if cfg.get(key, want) != want:
            raise ValueError(f"the reference models {key}={want} only")


def model_dims(cfg: dict):
    enc = cfg["encoder_dim"] + cfg["n_speaker_dim"]
    dec = cfg["decoder_dim"] + cfg["n_speaker_dim"]
    return enc, dec


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------

def _bn(out: dict, pre: str, c: int, affine: bool = True) -> None:
    if affine:
        out[pre + "weight"] = (c,)
        out[pre + "bias"] = (c,)
    out[pre + "running_mean"] = (c,)
    out[pre + "running_var"] = (c,)
    out[pre + "num_batches_tracked"] = ()


def _lin(out: dict, pre: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out[pre + "weight"] = (n_out, n_in)
    if bias:
        out[pre + "bias"] = (n_out,)


def _conv(out: dict, pre: str, n_in: int, n_out: int, k: int, bias: bool = True) -> None:
    out[pre + "weight"] = (n_out, n_in, k)
    if bias:
        out[pre + "bias"] = (n_out,)


def _fft_shapes(out: dict, pre: str, d_model: int, d_inner: int, n_head: int, d_k: int,
                kernel) -> None:
    for name in ("w_qs", "w_ks", "w_vs"):
        _lin(out, f"{pre}slf_attn.{name}.", d_model, n_head * d_k)
    _lin(out, f"{pre}slf_attn.fc.", n_head * d_k, d_model)
    out[f"{pre}slf_attn.layer_norm.weight"] = (d_model,)
    out[f"{pre}slf_attn.layer_norm.bias"] = (d_model,)
    _conv(out, f"{pre}pos_ffn.w_1.", d_model, d_inner, kernel[0])
    _conv(out, f"{pre}pos_ffn.w_2.", d_inner, d_model, kernel[1])
    out[f"{pre}pos_ffn.layer_norm.weight"] = (d_model,)
    out[f"{pre}pos_ffn.layer_norm.bias"] = (d_model,)


def _ecapa_shapes(out: dict, pre: str, C: int, n_in: int, n_spk: int) -> None:
    _conv(out, pre + "conv1.", n_in, C, 5)
    _bn(out, pre + "bn1.", C)
    width = C // ECAPA_SCALE
    for i, (k, _) in enumerate(ECAPA_LAYERS, start=1):
        lp = f"{pre}layer{i}."
        _conv(out, lp + "conv1.", C, width * ECAPA_SCALE, 1)
        _bn(out, lp + "bn1.", width * ECAPA_SCALE)
        for j in range(ECAPA_SCALE - 1):
            _conv(out, f"{lp}convs.{j}.", width, width, k)
            _bn(out, f"{lp}bns.{j}.", width)
        _conv(out, lp + "conv3.", width * ECAPA_SCALE, C, 1)
        _bn(out, lp + "bn3.", C)
        _conv(out, lp + "se.se.1.", C, 128, 1)
        _conv(out, lp + "se.se.3.", 128, C, 1)
    _conv(out, pre + "layer4.", 3 * C, 1536, 1)
    _conv(out, pre + "attention.0.", 4608, 256, 1)
    _bn(out, pre + "attention.2.", 256)
    _conv(out, pre + "attention.4.", 256, 1536, 1)
    _bn(out, pre + "bn5.", 3072)
    _lin(out, pre + "fc6.", 3072, n_spk)
    _bn(out, pre + "bn6.", n_spk)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every entry of the Text2Vec state dict with its shape."""
    _check(cfg)
    enc_d, dec_d = model_dims(cfg)
    F_ = cfg["n_feat_dim"]
    out: Dict[str, tuple] = {}
    out["encoder.src_word_emb.weight"] = (cfg["vocab_size"], cfg["encoder_dim"])
    out["encoder.position_enc.weight"] = (cfg["vocab_size"] + 1, cfg["encoder_dim"])
    _ecapa_shapes(out, "encoder.speaker_encoder.", cfg["spk_channel"], F_, cfg["n_speaker_dim"])
    for stack, d, inner, n_layer in (("encoder", enc_d, cfg["encoder_conv1d_filter_size"],
                                      cfg["encoder_n_layer"]),
                                     ("decoder", dec_d, cfg["decoder_conv1d_filter_size"],
                                      cfg["decoder_n_layer"])):
        head = cfg["encoder_head"] if stack == "encoder" else cfg["decoder_head"]
        for i in range(n_layer):
            _fft_shapes(out, f"{stack}.layer_stack.{i}.", d, inner, head,
                        d // cfg["encoder_head"], cfg["fft_conv1d_kernel"])
    out["decoder.position_enc.weight"] = (cfg["max_seq_len"] + 1, dec_d)
    dp = "length_regulator.duration_predictor."
    fs, ks = cfg["duration_predictor_filter_size"], cfg["duration_predictor_kernel_size"]
    _conv(out, dp + "conv_layer.conv1d_1.conv.", enc_d, fs, ks)
    out[dp + "conv_layer.layer_norm_1.weight"] = (fs,)
    out[dp + "conv_layer.layer_norm_1.bias"] = (fs,)
    _conv(out, dp + "conv_layer.conv1d_2.conv.", fs, fs, ks)
    out[dp + "conv_layer.layer_norm_2.weight"] = (fs,)
    out[dp + "conv_layer.layer_norm_2.bias"] = (fs,)
    _lin(out, dp + "linear_layer.linear_layer.", fs, 1)
    _lin(out, "WVF_linear.linear_layer.", dec_d, F_)
    for k in range(1, CBHG_K + 1):
        _conv(out, f"postnet.conv1d_banks.{k - 1}.conv1d.", F_, F_, k, bias=False)
        _bn(out, f"postnet.conv1d_banks.{k - 1}.bn.", F_)
    _conv(out, "postnet.conv1d_projections.0.conv1d.", CBHG_K * F_, 256, 3, bias=False)
    _bn(out, "postnet.conv1d_projections.0.bn.", 256)
    _conv(out, "postnet.conv1d_projections.1.conv1d.", 256, F_, 3, bias=False)
    _bn(out, "postnet.conv1d_projections.1.bn.", F_)
    out["postnet.pre_highway.weight"] = (F_, 1024)  # unused: projections end at F_
    for i in range(4):
        _lin(out, f"postnet.highways.{i}.H.", F_, F_)
        _lin(out, f"postnet.highways.{i}.T.", F_, F_)
    for sfx in ("", "_reverse"):
        out[f"postnet.gru.weight_ih_l0{sfx}"] = (3 * F_, F_)
        out[f"postnet.gru.weight_hh_l0{sfx}"] = (3 * F_, F_)
        out[f"postnet.gru.bias_ih_l0{sfx}"] = (3 * F_,)
        out[f"postnet.gru.bias_hh_l0{sfx}"] = (3 * F_,)
    _lin(out, "last_linear.linear_layer.", 2 * F_, F_)
    n_text = cfg["encoder_dim"] + cfg["n_speaker_dim"]
    _conv(out, "attention.key_proj.0.conv.", n_text, 2 * n_text, 3)
    _conv(out, "attention.key_proj.2.conv.", 2 * n_text, 80, 1)
    _conv(out, "attention.query_proj.0.conv.", F_, 2 * F_, 3)
    _conv(out, "attention.query_proj.2.conv.", 2 * F_, F_, 1)
    _conv(out, "attention.query_proj.4.conv.", F_, 80, 1)
    return out


def frozen_tables(cfg: dict) -> Dict[str, torch.Tensor]:
    """The two sinusoid position tables, which are not trained."""
    enc_d, dec_d = model_dims(cfg)
    return {"encoder.position_enc.weight":
            torch.from_numpy(sinusoid_table(cfg["vocab_size"] + 1, cfg["encoder_dim"])),
            "decoder.position_enc.weight":
            torch.from_numpy(sinusoid_table(cfg["max_seq_len"] + 1, dec_d))}


def is_trained(name: str) -> bool:
    """Whether LAMB trains the entry: parameters, not the position tables or
    the BatchNorm statistics."""
    return not (name.endswith("position_enc.weight") or name.endswith("running_mean")
                or name.endswith("running_var") or name.endswith("num_batches_tracked"))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def fft_block(P, pre: str, x, pad: torch.Tensor, n_head: int, d_k: int, cfg: dict, ops: Ops):
    """x [B, T, D], pad [B, T] bool (True at padding)."""
    B, T, _ = x.shape
    keep = (~pad).to(x.dtype)[..., None]

    def proj(name):
        return ops.linear(x, P[f"{pre}slf_attn.{name}.weight"],
                          P[f"{pre}slf_attn.{name}.bias"]).view(B, T, n_head, d_k)

    q, k, v = proj("w_qs"), proj("w_ks"), proj("w_vs")
    scores = ops.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d_k)
    scores = scores.masked_fill(pad[:, None, None, :], NEG)
    attn = torch.softmax(scores, dim=-1)
    o = ops.einsum("bhqk,bkhd->bqhd", attn, v).reshape(B, T, n_head * d_k)
    o = ops.linear(o, P[f"{pre}slf_attn.fc.weight"], P[f"{pre}slf_attn.fc.bias"])
    out = layer_norm(o + x, P[f"{pre}slf_attn.layer_norm.weight"],
                     P[f"{pre}slf_attn.layer_norm.bias"]) * keep
    kern, padd = cfg["fft_conv1d_kernel"], cfg["fft_conv1d_padding"]
    h = torch.relu(conv_btc(ops, out, P[f"{pre}pos_ffn.w_1.weight"], P[f"{pre}pos_ffn.w_1.bias"],
                            padding=padd[0]))
    h = conv_btc(ops, h, P[f"{pre}pos_ffn.w_2.weight"], P[f"{pre}pos_ffn.w_2.bias"],
                 padding=padd[1])
    return layer_norm(h + out, P[f"{pre}pos_ffn.layer_norm.weight"],
                      P[f"{pre}pos_ffn.layer_norm.bias"]) * keep


def ecapa(P, pre: str, x, train: bool, ops: Ops):
    """ECAPA-TDNN over features [B, T, n_feat] -> [B, n_speaker_dim]."""
    def conv(name, h, padding=0, dilation=1):
        return conv_btc(ops, h, P[pre + name + ".weight"], P[pre + name + ".bias"],
                        padding=padding, dilation=dilation)

    def bn(name, h):
        return batch_norm(h, P, pre + name + ".", train)

    x = bn("bn1", torch.relu(conv("conv1", x, padding=2)))
    outs, h = [], x
    for i, (k, d) in enumerate(ECAPA_LAYERS, start=1):
        lp = f"layer{i}"
        inp = h
        out = bn(lp + ".bn1", torch.relu(conv(lp + ".conv1", inp)))
        width = out.shape[-1] // ECAPA_SCALE
        spx = torch.split(out, width, dim=-1)
        parts, sp = [], None
        for j in range(ECAPA_SCALE - 1):
            sp = spx[j] if j == 0 else sp + spx[j]
            sp = bn(f"{lp}.bns.{j}", torch.relu(conv(f"{lp}.convs.{j}", sp, padding=(k // 2) * d,
                                                      dilation=d)))
            parts.append(sp)
        parts.append(spx[ECAPA_SCALE - 1])
        out = bn(lp + ".bn3", torch.relu(conv(lp + ".conv3", torch.cat(parts, dim=-1))))
        s = out.mean(dim=1, keepdim=True)
        s = torch.sigmoid(conv(lp + ".se.se.3", torch.relu(conv(lp + ".se.se.1", s))))
        outs.append(out * s + inp)
        h = x + sum(outs)
    x = torch.relu(conv("layer4", torch.cat(outs, dim=-1)))
    T = x.shape[1]
    mean = x.mean(dim=1, keepdim=True)
    std = torch.sqrt(x.var(dim=1, keepdim=True, unbiased=T > 1).clamp(min=1e-4))
    g = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
    w = conv("attention.0", g)
    w = torch.tanh(bn("attention.2", torch.relu(w)))
    w = torch.softmax(conv("attention.4", w), dim=1)
    mu = torch.sum(x * w, dim=1)
    sg = torch.sqrt((torch.sum(x * x * w, dim=1) - mu * mu).clamp(min=1e-4))
    x = bn("bn5", torch.cat([mu, sg], dim=-1))
    return bn("bn6", ops.linear(x, P[pre + "fc6.weight"], P[pre + "fc6.bias"]))


def encoder(P, ids, pos, spk, cfg: dict, ops: Ops):
    """ids/pos [B, N] int, spk [B, n_speaker_dim] -> [B, N, encoder_dim + spk]."""
    pad = ids == 0
    emb = P["encoder.src_word_emb.weight"][ids] * (~pad)[..., None].float()
    x = emb + P["encoder.position_enc.weight"][pos.clamp(max=cfg["vocab_size"])]
    B, N, _ = x.shape
    x = torch.cat([x, spk[:, None, :].expand(B, N, spk.shape[-1])], dim=-1)
    d_k = x.shape[-1] // cfg["encoder_head"]
    for i in range(cfg["encoder_n_layer"]):
        x = _block(P, f"encoder.layer_stack.{i}.", x, pad, cfg["encoder_head"], d_k, cfg, ops)
    return x


def decoder(P, x, frame_pos, cfg: dict, ops: Ops):
    pad = frame_pos == 0
    x = x + P["decoder.position_enc.weight"][frame_pos.clamp(max=cfg["max_seq_len"])]
    d_k = x.shape[-1] // cfg["encoder_head"]
    for i in range(cfg["decoder_n_layer"]):
        x = _block(P, f"decoder.layer_stack.{i}.", x, pad, cfg["decoder_head"], d_k, cfg, ops)
    return x


def _block(P, pre, x, pad, n_head, d_k, cfg, ops: Ops):
    """An FFT block, recomputed in the backward where ``ops.remat`` (its
    dense attention keeps B H T^2 floats a layer otherwise)."""
    if ops.remat and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fft_block, P, pre, x, pad, n_head, d_k, cfg, ops, use_reentrant=False)
    return fft_block(P, pre, x, pad, n_head, d_k, cfg, ops)


def duration_predictor(P, x, ops: Ops):
    pre = "length_regulator.duration_predictor.conv_layer."
    for i in (1, 2):
        x = conv_btc(ops, x, P[f"{pre}conv1d_{i}.conv.weight"], P[f"{pre}conv1d_{i}.conv.bias"],
                     padding=1)
        x = torch.relu(layer_norm(x, P[f"{pre}layer_norm_{i}.weight"],
                                  P[f"{pre}layer_norm_{i}.bias"]))
    lin = "length_regulator.duration_predictor.linear_layer.linear_layer."
    return torch.relu(ops.linear(x, P[lin + "weight"], P[lin + "bias"]))[..., 0]


def bigru(P, x, ops: Ops):
    """Bidirectional GRU over [B, T, C] -> [B, T, 2H], f32 state."""
    outs = []
    for sfx, seq in (("", x), ("_reverse", torch.flip(x, dims=(1,)))):
        w_ih, w_hh = P[f"postnet.gru.weight_ih_l0{sfx}"], P[f"postnet.gru.weight_hh_l0{sfx}"]
        b_ih, b_hh = P[f"postnet.gru.bias_ih_l0{sfx}"], P[f"postnet.gru.bias_hh_l0{sfx}"]
        H = w_hh.shape[1]
        gi = ops.linear(seq, w_ih, b_ih)  # [B, T, 3H]
        w_hh = ops.q(w_hh)  # rounded once, not once a step
        h = seq.new_zeros(seq.shape[0], H)
        ys = []
        for t in range(seq.shape[1]):
            gh = F.linear(ops.q(h), w_hh, b_hh)
            g = gi[:, t]
            r = torch.sigmoid(g[:, :H] + gh[:, :H])
            z = torch.sigmoid(g[:, H:2 * H] + gh[:, H:2 * H])
            n = torch.tanh(g[:, 2 * H:] + r * gh[:, 2 * H:])
            h = (1.0 - z) * n + z * h
            ys.append(h)
        y = torch.stack(ys, dim=1)
        outs.append(y if sfx == "" else torch.flip(y, dims=(1,)))
    return torch.cat(outs, dim=-1)


def cbhg(P, x, train: bool, ops: Ops):
    T = x.shape[1]
    banks = []
    for k in range(1, CBHG_K + 1):
        pre = f"postnet.conv1d_banks.{k - 1}."
        h = torch.relu(conv_btc(ops, x, P[pre + "conv1d.weight"], padding=k // 2))
        banks.append(batch_norm(h, P, pre + "bn.", train)[:, :T])
    h = torch.cat(banks, dim=-1)
    h = F.max_pool1d(h.transpose(1, 2), kernel_size=2, stride=1, padding=1)[:, :, :T]
    h = h.transpose(1, 2)
    for i, act in ((0, True), (1, False)):
        pre = f"postnet.conv1d_projections.{i}."
        h = conv_btc(ops, h, P[pre + "conv1d.weight"], padding=1)
        if act:
            h = torch.relu(h)
        h = batch_norm(h, P, pre + "bn.", train)
    h = h + x
    for i in range(4):
        pre = f"postnet.highways.{i}."
        hh = torch.relu(ops.linear(h, P[pre + "H.weight"], P[pre + "H.bias"]))
        tt = torch.sigmoid(ops.linear(h, P[pre + "T.weight"], P[pre + "T.bias"]))
        h = hh * tt + h * (1.0 - tt)
    return bigru(P, h, ops)


def postnet_stage(P, dec, frame_lens, train: bool, ops: Ops):
    """Decoder output -> (features, postnet features), both zero past each
    item's frames."""
    T = dec.shape[1]
    keep = (torch.arange(T, device=dec.device)[None] < frame_lens[:, None]).float()[..., None]
    wvf = ops.linear(dec, P["WVF_linear.linear_layer.weight"],
                     P["WVF_linear.linear_layer.bias"]) * keep
    res = ops.linear(cbhg(P, wvf, train, ops), P["last_linear.linear_layer.weight"],
                     P["last_linear.linear_layer.bias"])
    return wvf, (wvf + res) * keep


def conv_attention(P, feats, text, text_lens, prior, ops: Ops):
    """Soft alignment [B, T, N] (softmax over text) and its log-probabilities."""
    def proj(h, names):
        for j, name in enumerate(names):
            w, b = P[f"attention.{name}.conv.weight"], P[f"attention.{name}.conv.bias"]
            h = conv_btc(ops, h, w, b, padding=(w.shape[-1] - 1) // 2)
            if j < len(names) - 1:
                h = torch.relu(h)
        return h

    k = proj(text, ("key_proj.0", "key_proj.2"))
    q = proj(feats, ("query_proj.0", "query_proj.2", "query_proj.4"))
    dist = (q * q).sum(-1)[:, :, None] + (k * k).sum(-1)[:, None, :] - 2.0 * ops.matmul(
        q, k.transpose(1, 2))
    logp = F.log_softmax(-TEMPERATURE * dist, dim=2) + torch.log(prior + 1e-8)
    valid = torch.arange(text.shape[1], device=text.device)[None] < text_lens[:, None]
    soft = torch.softmax(logp.masked_fill(~valid[:, None, :], NEG), dim=2)
    return soft, logp


def mas(attn: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search of width 1 over [B, T, N] -> hard 0/1:
    log-domain Viterbi, the path starting at text 0 and ending at
    (out_len - 1, in_len - 1), a tie going to the left neighbour."""
    neg = -1e30
    B, T, N = attn.shape
    dev = attn.device
    col = torch.arange(N, device=dev)
    la = torch.log(attn.float().clamp(min=0.0)).clamp(min=neg)
    la = torch.where(col < in_lens[:, None, None], la, la.new_full((), neg))
    la[:, 0, 1:] = neg
    left = torch.zeros(B, T, N, dtype=torch.bool, device=dev)
    lp = la[:, 0]
    edge = la.new_full((B, 1), neg)
    for i in range(1, T):
        sh = torch.cat([edge, lp[:, :-1]], dim=1)
        left[:, i] = sh >= lp
        lp = la[:, i] + torch.maximum(sh, lp)
    hard = torch.zeros(B, T, N, device=dev, dtype=attn.dtype)
    cur = in_lens.long() - 1
    for i in range(T - 1, -1, -1):
        on = i < out_lens
        hard[:, i] = ((col == cur[:, None]) & on[:, None]).to(attn.dtype)
        came = left[:, i].gather(1, cur.clamp(min=0)[:, None])[:, 0] & (cur >= 0)
        cur = cur - (on & came & (i > 0)).long()
    hard[:, 0, 0] = torch.where(out_lens > 0, 1.0, hard[:, 0, 0])
    return hard


# ---------------------------------------------------------------------------
# inference and the training loss
# ---------------------------------------------------------------------------

def speaker_embedding(P, clips, cfg: dict, ops: Ops):
    """Eval-mode ECAPA over reference clips [B, T, n_feat]."""
    return ecapa(P, "encoder.speaker_encoder.", clips, False, ops)


def infer(P, ids, spk, max_frames: int, cfg: dict, ops: Ops,
          durations: Optional[torch.Tensor] = None):
    """ids [B, N] (0 = pad), spk [B, n_speaker_dim] -> dict of the
    duration predictor's output ``dp`` [B, N], the durations used [B, N] and
    the postnet features [B, max_frames, n_feat].  ``durations`` replaces
    ``floor(dp + 0.5)`` (a served request's own durations)."""
    pos = torch.where(ids != 0, torch.arange(1, ids.shape[1] + 1, device=ids.device)[None], 0)
    enc = encoder(P, ids, pos, spk, cfg, ops)
    dp = duration_predictor(P, enc, ops)
    if durations is None:
        durations = torch.floor(dp + 0.5).long() * (ids != 0).long()
    ends = torch.cumsum(durations, dim=1)
    total = ends[:, -1]
    t = torch.arange(max_frames, device=ids.device)[None].expand(ids.shape[0], -1)
    idx = torch.searchsorted(ends, t.contiguous(), right=True).clamp(max=ids.shape[1] - 1)
    lr = torch.gather(enc, 1, idx[..., None].expand(-1, -1, enc.shape[-1]))
    lr = lr * (t < total[:, None]).float()[..., None]
    frame_pos = torch.where(t < total[:, None], t + 1, 0)
    dec = decoder(P, lr, frame_pos, cfg, ops)
    frames = total.clamp(max=max_frames)
    _, post = postnet_stage(P, dec, frames, False, ops)
    return {"dp": dp, "durations": durations, "total": total, "latents": post}


def path_valid(hard: torch.Tensor, in_lens: torch.Tensor, out_lens: torch.Tensor) -> torch.Tensor:
    """[B]: whether each item's ``hard`` [B, T, N] is a width-1 monotonic
    alignment for its lengths: 0/1 entries, exactly one 1 in each frame below
    ``out_len`` and none past it or past ``in_len``, starting at text 0,
    ending at ``in_len - 1``, the text index rising by 0 or 1 a frame."""
    h = hard.float()
    B, T, N = h.shape
    on = torch.arange(T, device=h.device)[None] < out_lens[:, None]
    past = torch.arange(N, device=h.device)[None, None] >= in_lens[:, None, None]
    ok = ((h == 0) | (h == 1)).flatten(1).all(1)
    ok &= (h.sum(2) == on.float()).all(1)
    ok &= ~(past & (h != 0)).flatten(1).any(1)
    idx = h.argmax(2)
    step = idx[:, 1:] - idx[:, :-1]
    ok &= (((step == 0) | (step == 1)) | ~on[:, 1:]).all(1)
    last = idx.gather(1, (out_lens.long() - 1).clamp(min=0)[:, None])[:, 0]
    return ok & (idx[:, 0] == 0) & (last == in_lens.long() - 1)


def path_score(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """[B]: the log-likelihood of each item's alignment path under ``soft``."""
    return torch.sum(hard * torch.log(soft.clamp(min=1e-30)), dim=(1, 2))


def train_losses(P, batch: Dict[str, torch.Tensor], cfg: dict, ops: Ops,
                 hard: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The training forward in train mode (BatchNorm on batch statistics)
    and its losses ``LOSS_KEYS``; also ``hard``, the alignment it used, and
    with a ``hard`` given (another run's search, which it then uses)
    ``mas_gap``, the largest amount by which that path's log-likelihood lies
    below the best path's under this run's soft alignment: infinite where
    the path given is no width-1 monotonic alignment (``path_valid``)."""
    tgt = batch["feat_target"]
    spk = ecapa(P, "encoder.speaker_encoder.", tgt, True, ops)
    enc = encoder(P, batch["text"], batch["src_pos"], spk, cfg, ops)
    soft, _ = conv_attention(P, tgt, enc, batch["input_lengths"], batch["attn_prior"], ops)
    best = mas(soft.detach(), batch["input_lengths"], batch["output_lengths"])
    gap = None
    if hard is None:
        hard = best
    else:
        gap = torch.max(path_score(best, soft.detach()) - path_score(hard, soft.detach()))
        if not bool(path_valid(hard, batch["input_lengths"], batch["output_lengths"]).all()):
            gap = torch.full_like(gap, math.inf)
    duration = hard.sum(dim=1)
    lr = torch.matmul(hard, enc)  # 0/1 selection: no product to round
    dp = duration_predictor(P, enc, ops)
    dec = decoder(P, lr, batch["feat_pos"], cfg, ops)
    wvf, post = postnet_stage(P, dec, batch["output_lengths"], True, ops)
    wvf_loss = torch.mean((wvf - tgt) ** 2)
    post_loss = torch.mean((post - tgt) ** 2)
    dur_loss = torch.mean((dp - duration) ** 2)
    log_sum = torch.sum(torch.where(hard == 1, torch.log(soft.clamp(min=1e-12)), 0.0))
    bin_loss = -log_sum / hard.sum().clamp(min=1.0)
    total = wvf_loss + post_loss + dur_loss + cfg["binarization_loss_weight"] * bin_loss
    out = dict(zip(LOSS_KEYS, (total, wvf_loss, post_loss, dur_loss, bin_loss)))
    out["hard"] = hard
    if gap is not None:
        out["mas_gap"] = gap
    return out
