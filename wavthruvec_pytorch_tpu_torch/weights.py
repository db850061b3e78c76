"""Carry the JAX package's model variables into the port's state dicts.

Input: a Flax variable tree ``{"params", "batch_stats", "spectral"}`` whose
leaves are numpy arrays (e.g. ``jax.tree_util.tree_map(np.asarray, vars)``).
Output: a ``{key: torch.Tensor}`` state dict in the torch reference's key
layout, which the port's ``Text2Vec``, ``Generator`` and discriminators
load with ``strict=True``.  Keys and values equal those of the JAX package's
``checkpoint.export_text2vec`` / ``export_vec2wav_generator`` /
``export_vec2wav_mpd`` / ``export_vec2wav_msd``: this module keeps its own
copy of their spec tables and layout transposes (``checkpoint.py:117-152,
185-336, 379-423, 467-510``).  A tree of gradients in the layout of
``params`` maps the same way (pass it as ``{"params": grads}``).

Spec kinds (one row = one torch module or tensor):

  emb    single tensor copied as is (torch key given in full)
  lin    Linear  .weight/.bias        <- {dst}/kernel (in, out), {dst}/bias
  conv   Conv1d  .weight/.bias        <- {dst}/kernel (k, in, out), {dst}/bias
  ln     LayerNorm .weight/.bias      <- {dst}/scale, {dst}/bias
  bn     BatchNorm1d affine + stats   <- {dst}/BatchNorm_0/{scale,bias} + batch_stats
  bn_na  BatchNorm1d stats only
  wn     weight-normed Conv1d (wnT: ConvTranspose1d, wn2d: Conv2d) .weight_{g,v}/.bias
  snlin  spectral-normed Linear .weight_orig/.bias + spectral .weight_{u,v}
  sn     spectral-normed Conv1d, the same keys
  linw   single Linear-layout weight (GRU weights; torch key given in full)
  raw    single tensor, no transform (GRU biases; torch key given in full)
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.ops.positional import sinusoid_encoding_table

Spec = List[Tuple[str, str, str]]


def _get(tree: Any, path: str):
    node = tree
    for k in path.split("/"):
        if not hasattr(node, "get") or node.get(k) is None:
            return None
        node = node[k]
    return np.asarray(node)


def _ecapa_spec(src: str, dst: str) -> Spec:
    s: Spec = [("conv", f"{src}.conv1", f"{dst}/conv1/Conv_0"), ("bn", f"{src}.bn1", f"{dst}/bn1")]
    for li in (1, 2, 3):
        b, d = f"{src}.layer{li}", f"{dst}/layer{li}"
        s += [("conv", f"{b}.conv1", f"{d}/conv1/Conv_0"), ("bn", f"{b}.bn1", f"{d}/bn1")]
        for ci in range(7):
            s += [("conv", f"{b}.convs.{ci}", f"{d}/convs_{ci}/Conv_0"),
                  ("bn", f"{b}.bns.{ci}", f"{d}/bns_{ci}")]
        s += [("conv", f"{b}.conv3", f"{d}/conv3/Conv_0"), ("bn", f"{b}.bn3", f"{d}/bn3"),
              ("conv", f"{b}.se.se.1", f"{d}/se/Conv1d_0/Conv_0"),
              ("conv", f"{b}.se.se.3", f"{d}/se/Conv1d_1/Conv_0")]
    s += [("conv", f"{src}.layer4", f"{dst}/layer4/Conv_0"),
          ("conv", f"{src}.attention.0", f"{dst}/att_conv1/Conv_0"),
          ("bn", f"{src}.attention.2", f"{dst}/att_bn"),
          ("conv", f"{src}.attention.4", f"{dst}/att_conv2/Conv_0"),
          ("bn", f"{src}.bn5", f"{dst}/bn5"),
          ("lin", f"{src}.fc6", f"{dst}/fc6/Dense_0"),
          ("bn", f"{src}.bn6", f"{dst}/bn6")]
    return s


def _fft_stack_spec(src: str, dst: str, n_layers: int) -> Spec:
    s: Spec = []
    for i in range(n_layers):
        b, d = f"{src}.layer_stack.{i}", f"{dst}/layer_stack_{i}"
        for name in ("w_qs", "w_ks", "w_vs", "fc"):
            s.append(("lin", f"{b}.slf_attn.{name}", f"{d}/slf_attn/{name}"))
        s.append(("ln", f"{b}.slf_attn.layer_norm", f"{d}/slf_attn/LayerNorm_0/LayerNorm_0"))
        for w in ("w_1", "w_2"):
            s.append(("conv", f"{b}.pos_ffn.{w}", f"{d}/pos_ffn/{w}/Conv_0"))
        s.append(("ln", f"{b}.pos_ffn.layer_norm", f"{d}/pos_ffn/LayerNorm_0/LayerNorm_0"))
    return s


def _text2vec_spec(cfg) -> Spec:
    s: Spec = [("emb", "encoder.src_word_emb.weight", "encoder/src_word_emb")]
    if cfg.use_multi_speaker_condition:
        s += _ecapa_spec("encoder.speaker_encoder", "encoder/speaker_encoder")
    s += _fft_stack_spec("encoder", "encoder", cfg.encoder_n_layer)
    s += _fft_stack_spec("decoder", "decoder", cfg.decoder_n_layer)
    dp = "length_regulator.duration_predictor"
    for i in (1, 2):
        s += [("conv", f"{dp}.conv_layer.conv1d_{i}.conv", f"duration_predictor/conv1d_{i}/Conv_0"),
              ("ln", f"{dp}.conv_layer.layer_norm_{i}",
               f"duration_predictor/layer_norm_{i}/LayerNorm_0")]
    s.append(("lin", f"{dp}.linear_layer.linear_layer", "duration_predictor/linear_layer/Dense_0"))
    for name in ("WVF_linear", "last_linear"):
        s.append(("lin", f"{name}.linear_layer", f"{name}/Dense_0"))
    for k in range(8):
        s += [("conv", f"postnet.conv1d_banks.{k}.conv1d", f"postnet/conv1d_banks_{k}/conv1d/Conv_0"),
              ("bn", f"postnet.conv1d_banks.{k}.bn", f"postnet/conv1d_banks_{k}/bn")]
    for i in range(2):
        s += [("conv", f"postnet.conv1d_projections.{i}.conv1d",
               f"postnet/conv1d_projections_{i}/conv1d/Conv_0"),
              ("bn", f"postnet.conv1d_projections.{i}.bn", f"postnet/conv1d_projections_{i}/bn")]
    for i in range(4):
        s += [("lin", f"postnet.highways.{i}.H", f"postnet/highways_{i}/Dense_0"),
              ("lin", f"postnet.highways.{i}.T", f"postnet/highways_{i}/Dense_1")]
    for d_, t_ in (("fwd", ""), ("bwd", "_reverse")):
        s += [("linw", f"postnet.gru.weight_ih_l0{t_}", f"postnet/gru/{d_}_w_ih"),
              ("linw", f"postnet.gru.weight_hh_l0{t_}", f"postnet/gru/{d_}_w_hh"),
              ("raw", f"postnet.gru.bias_ih_l0{t_}", f"postnet/gru/{d_}_b_ih"),
              ("raw", f"postnet.gru.bias_hh_l0{t_}", f"postnet/gru/{d_}_b_hh")]
    if cfg.learn_alignments:
        s += [("conv", "attention.key_proj.0.conv", "attention/key_conv1/Conv_0"),
              ("conv", "attention.key_proj.2.conv", "attention/key_conv2/Conv_0"),
              ("conv", "attention.query_proj.0.conv", "attention/query_conv1/Conv_0"),
              ("conv", "attention.query_proj.2.conv", "attention/query_conv2/Conv_0"),
              ("conv", "attention.query_proj.4.conv", "attention/query_conv3/Conv_0")]
    return s


def _generator_spec(cfg) -> Spec:
    s: Spec = [("wn", "conv_pre", "conv_pre"), ("wn", "conv_post", "conv_post")]
    for i in range(len(cfg.upsample_rates)):
        s += [("wnT", f"ups.{i}", f"ups_{i}"),
              ("lin", f"fcs.{i}", f"fcs_{i}/Dense_0"),
              ("bn_na", f"cbns.{i}.batch_nrom", f"cbns_{i}/batch_norm"),
              ("snlin", f"cbns.{i}.layer", f"cbns_{i}/layer")]
    n_kernels = len(cfg.resblock_kernel_sizes)
    for n in range(len(cfg.upsample_rates) * n_kernels):
        if cfg.use_resblock1:
            # one unit per dilation, at most 3 (ResBlock1 takes dilation[:3])
            for j in range(len(cfg.resblock_dilation_sizes[n % n_kernels][:3])):
                s += [("wn", f"resblocks.{n}.convs1.{j}", f"resblocks_{n}/convs1_{j}"),
                      ("wn", f"resblocks.{n}.convs2.{j}", f"resblocks_{n}/convs2_{j}")]
        else:
            for j in range(2):
                s.append(("wn", f"resblocks.{n}.convs.{j}", f"resblocks_{n}/convs_{j}"))
    return s


def _mpd_spec(cfg) -> Spec:
    s: Spec = []
    for i in range(len(cfg.periods)):
        s += [("wn2d", f"discriminators.{i}.convs.{j}", f"discriminators_{i}/convs_{j}")
              for j in range(5)]
        s.append(("wn2d", f"discriminators.{i}.conv_post", f"discriminators_{i}/conv_post"))
    return s


def _msd_spec() -> Spec:
    s: Spec = []
    for i in range(3):
        kind = "sn" if i == 0 else "wn"
        s += [(kind, f"discriminators.{i}.convs.{j}", f"discriminators_{i}/convs_{j}")
              for j in range(7)]
        s.append((kind, f"discriminators.{i}.conv_post", f"discriminators_{i}/conv_post"))
    return s


# flax (k, in, out) / (in, out) layouts -> torch
def _conv(w):  # Conv1d (k, in, out) -> [out, in, k]
    return np.transpose(w, (2, 1, 0))


def _convT(w):  # ConvTranspose1d (k, in, out) -> [in, out, k]
    return np.transpose(w, (1, 2, 0))


def _conv2d(w):  # Conv2d (kh, kw, in, out) -> [out, in, kh, kw]
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w):  # Linear (in, out) -> [out, in]
    return np.transpose(w)


_WN_LAYOUT = {"wn": _conv, "wnT": _convT, "wn2d": _conv2d}


def _export(np_vars: Any, spec: Spec) -> Dict[str, np.ndarray]:
    params = np_vars.get("params", {})
    stats = np_vars.get("batch_stats", {})
    spectral = np_vars.get("spectral", {})
    sd: Dict[str, np.ndarray] = {}

    def put(key, value):
        if value is not None:
            sd[key] = np.asarray(value)

    for kind, src, dst in spec:
        if kind in ("emb", "raw"):
            put(src, _get(params, dst))
        elif kind == "linw":
            put(src, _lin(_get(params, dst)))
        elif kind in ("lin", "conv"):
            trans = _lin if kind == "lin" else _conv
            put(f"{src}.weight", trans(_get(params, f"{dst}/kernel")))
            put(f"{src}.bias", _get(params, f"{dst}/bias"))
        elif kind == "ln":
            put(f"{src}.weight", _get(params, f"{dst}/scale"))
            put(f"{src}.bias", _get(params, f"{dst}/bias"))
        elif kind in ("bn", "bn_na"):
            if kind == "bn":
                put(f"{src}.weight", _get(params, f"{dst}/BatchNorm_0/scale"))
                put(f"{src}.bias", _get(params, f"{dst}/BatchNorm_0/bias"))
            put(f"{src}.running_mean", _get(stats, f"{dst}/BatchNorm_0/mean"))
            put(f"{src}.running_var", _get(stats, f"{dst}/BatchNorm_0/var"))
            put(f"{src}.num_batches_tracked", np.zeros((), np.int64))
        elif kind in _WN_LAYOUT:
            trans = _WN_LAYOUT[kind]
            put(f"{src}.weight_v", trans(_get(params, f"{dst}/v")))
            put(f"{src}.weight_g", trans(_get(params, f"{dst}/g")))
            put(f"{src}.bias", _get(params, f"{dst}/bias"))
        elif kind in ("snlin", "sn"):
            trans = _lin if kind == "snlin" else _conv
            put(f"{src}.weight_orig", trans(_get(params, f"{dst}/kernel")))
            put(f"{src}.bias", _get(params, f"{dst}/bias"))
            put(f"{src}.weight_u", _get(spectral, f"{dst}/u"))
            put(f"{src}.weight_v", _get(spectral, f"{dst}/v"))
        else:
            raise ValueError(f"unknown spec kind {kind}")
    return sd


def _to_torch(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # torch.tensor copies: the numpy leaves may be read-only views
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def text2vec_state_dict(np_vars: Any, cfg) -> Dict[str, torch.Tensor]:
    """Text2Vec variables -> the port's ``Text2Vec`` state dict.

    Also emits the frozen sinusoid ``position_enc`` tables and, when the
    variables have none, the reference's dead ``postnet.pre_highway`` weight
    as zeros of shape [n_feat_dim, 1024] (as ``export_text2vec`` does)."""
    sd = _export(np_vars, _text2vec_spec(cfg))
    sd["encoder.position_enc.weight"] = sinusoid_encoding_table(
        cfg.vocab_size + 1, cfg.encoder_dim, padding_idx=0)
    sd["decoder.position_enc.weight"] = sinusoid_encoding_table(
        cfg.max_seq_len + 1, cfg.decoder_model_dim, padding_idx=0)
    if "postnet.pre_highway.weight" not in sd:
        pre = _get(np_vars.get("params", {}), "postnet/pre_highway/Dense_0/kernel")
        sd["postnet.pre_highway.weight"] = (
            _lin(pre) if pre is not None else np.zeros((cfg.n_feat_dim, 1024), np.float32))
    return _to_torch(sd)


def generator_state_dict(np_vars: Any, cfg) -> Dict[str, torch.Tensor]:
    """Generator variables -> the port's ``Generator`` state dict."""
    return _to_torch(_export(np_vars, _generator_spec(cfg)))


def mpd_state_dict(np_vars: Any, cfg) -> Dict[str, torch.Tensor]:
    """MultiPeriodDiscriminator variables -> the port's
    ``MultiPeriodDiscriminator`` state dict."""
    return _to_torch(_export(np_vars, _mpd_spec(cfg)))


def msd_state_dict(np_vars: Any) -> Dict[str, torch.Tensor]:
    """MultiScaleDiscriminator variables (``params`` and ``spectral``) -> the
    port's ``MultiScaleDiscriminator`` state dict."""
    return _to_torch(_export(np_vars, _msd_spec()))
