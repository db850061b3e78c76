"""wav2vec 2.0 feature model (the port's counterpart of HuggingFace
transformers' ``FlaxWav2Vec2Model``, which the JAX package's featurizer runs:
data/ingest.py).

The variant is the one Flax supports, and the one of the checkpoint the
reference featurizes with (TencentGameMate ``chinese-wav2vec2-large``):
``feat_extract_norm="layer"`` (every feature-encoder convolution followed by
a LayerNorm over channels and GELU) and ``do_stable_layer_norm=True``
(pre-LN encoder layers and a final LayerNorm).  A config with group norm or
post-LN layers raises, as Flax does (transformers
``modeling_flax_wav2vec2.py``, ``FlaxConvLayersCollection`` and
``FlaxWav2Vec2Module.setup``); so does ``add_adapter``, which the port does
not build.

Pieces, as Flax computes them:

* feature encoder: VALID convolutions (kernels ``conv_kernel``, strides
  ``conv_stride``), each + LayerNorm(eps ``layer_norm_eps``) + activation;
* feature projection: LayerNorm + Linear to ``hidden_size``;
* the feature-level attention mask from ``feat_extract_output_lengths`` of
  each waveform's samples; padded frames are zeroed before the positional
  convolution;
* positional convolution: weight-normed (the norm per kernel tap, over the
  output and input channels: torch's ``weight_norm(dim=2)``), kernel
  ``num_conv_pos_embeddings``, ``num_conv_pos_embedding_groups`` groups,
  padded by half the kernel on each side and its last frame dropped for an
  even kernel, then the activation, added to its input;
* ``num_hidden_layers`` pre-LN layers: x + attn(LN(x)), then x + FFN(LN(x));
  the attention is plain PyTorch in f32 (scaled query, key bias at f32's
  lowest value where masked, softmax), with no Pallas kernel behind it in
  JAX either; then the final LayerNorm.

HF's ``"gelu"`` is the exact (erf) GELU, ``F.gelu``'s default.  Dropout is
left out: the model only runs inference here.

Parameter names are HF's torch ``Wav2Vec2Model``'s
(``feature_extractor.conv_layers.{i}.conv.weight``,
``encoder.pos_conv_embed.conv.weight_g``/``weight_v``,
``encoder.layers.{i}.attention.q_proj.weight``, ``masked_spec_embed``, ...),
so a local checkpoint directory loads with ``strict=True``
(``load_pretrained``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.device import resolve_device

_ACT = {"gelu": F.gelu, "relu": F.relu, "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu,
        "swish": F.silu, "tanh": torch.tanh}


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The fields of transformers' ``Wav2Vec2Config`` that the model reads,
    with its defaults; ``from_dict`` ignores the rest of a ``config.json``."""

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    layer_norm_eps: float = 1e-5
    feat_extract_norm: str = "group"
    feat_extract_activation: str = "gelu"
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    do_stable_layer_norm: bool = False
    add_adapter: bool = False

    @classmethod
    def from_dict(cls, raw: dict) -> "Wav2Vec2Config":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in raw.items() if k in names}
        return cls(**kw)

    def to_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(self).items()}


def check_supported(cfg: Wav2Vec2Config) -> None:
    """Raise for a config Flax's model refuses, or the port does not build."""
    if cfg.feat_extract_norm != "layer":
        raise NotImplementedError(
            f"feat_extract_norm={cfg.feat_extract_norm!r}: only 'layer' is supported, as in "
            "transformers' FlaxWav2Vec2Model (the JAX package's featurizer)")
    if not cfg.do_stable_layer_norm:
        raise NotImplementedError(
            "do_stable_layer_norm=False (post-LN encoder layers) is not supported, as in "
            "transformers' FlaxWav2Vec2Model (the JAX package's featurizer)")
    if cfg.add_adapter:
        raise NotImplementedError("add_adapter=True: the port builds no adapter layers")
    if len({len(cfg.conv_dim), len(cfg.conv_kernel), len(cfg.conv_stride)}) != 1:
        raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")


def feat_extract_output_lengths(lengths, cfg: Wav2Vec2Config):
    """Frames the feature encoder makes of ``lengths`` samples (an int or an
    integer tensor/array): ``(L - k) // s + 1`` per convolution."""
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


class LayerNormConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, layer_id: int, device=None):
        super().__init__()
        c_in = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        c_out = cfg.conv_dim[layer_id]
        self.conv = nn.Conv1d(c_in, c_out, cfg.conv_kernel[layer_id],
                              stride=cfg.conv_stride[layer_id], bias=cfg.conv_bias,
                              device=device)
        self.layer_norm = nn.LayerNorm(c_out, eps=cfg.layer_norm_eps, device=device)
        self.act = _ACT[cfg.feat_extract_activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, C_out, T']"""
        y = self.layer_norm(self.conv(x).transpose(1, 2))
        return self.act(y).transpose(1, 2)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.conv_layers = nn.ModuleList(LayerNormConvLayer(cfg, i, device=device)
                                         for i in range(len(cfg.conv_dim)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, L] -> [B, T, conv_dim[-1]]"""
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps, device=device)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class WeightNormConv(nn.Module):
    """The positional convolution: ``weight_g`` [1, 1, k], ``weight_v``
    [out, in / groups, k] (torch's ``weight_norm(dim=2)``), ``bias``."""

    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        h, k, g = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
        self.groups, self.padding = g, k // 2
        v = torch.empty(h, h // g, k, device=device)
        nn.init.kaiming_normal_(v)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(torch.linalg.vector_norm(v, dim=(0, 1), keepdim=True))
        self.bias = nn.Parameter(torch.zeros(h, device=device))

    def weight(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.weight_v, dim=(0, 1), keepdim=True)
        return self.weight_v / norm * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, C, T + 1 - (k % 2)]"""
        return F.conv1d(x, self.weight(), self.bias, padding=self.padding, groups=self.groups)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.conv = WeightNormConv(cfg, device=device)
        self.num_pad_remove = 1 if cfg.num_conv_pos_embeddings % 2 == 0 else 0
        self.act = _ACT[cfg.feat_extract_activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] -> [B, T, C]"""
        y = self.conv(x.transpose(1, 2))
        if self.num_pad_remove:
            y = y[:, :, : -self.num_pad_remove]
        return self.act(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // self.num_heads
        if self.head_dim * self.num_heads != h:
            raise ValueError(f"hidden_size {h} is no multiple of num_attention_heads "
                             f"{self.num_heads}")
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(h, h, device=device) for _ in range(4))

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, T, C], key_bias [B, 1, 1, T] (0 or f32's lowest) -> [B, T, C]"""
        B, T, C = x.shape

        def heads(y):
            return y.reshape(B, T, self.num_heads, self.head_dim).transpose(1, 2)

        q = heads(self.q_proj(x)) / math.sqrt(self.head_dim)
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = torch.matmul(q, k.transpose(-1, -2))
        if key_bias is not None:
            scores = scores + key_bias
        attn = torch.softmax(scores, dim=-1)
        return self.out_proj(torch.matmul(attn, v).transpose(1, 2).reshape(B, T, C))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size, device=device)
        self.act = _ACT[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(self.act(self.intermediate_dense(x)))


class EncoderLayerStableLayerNorm(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.attention = Attention(cfg, device=device)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.feed_forward = FeedForward(cfg, device=device)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                             device=device)

    def forward(self, x: torch.Tensor, key_bias: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.attention(self.layer_norm(x), key_bias)
        return x + self.feed_forward(self.final_layer_norm(x))


class EncoderStableLayerNorm(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg, device=device)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.layers = nn.ModuleList(EncoderLayerStableLayerNorm(cfg, device=device)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        key_bias = None
        if mask is not None:
            x = torch.where(mask[:, :, None], x, 0.0)
            key_bias = torch.where(mask, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]
        x = x + self.pos_conv_embed(x)
        for layer in self.layers:
            x = layer(x, key_bias)
        return self.layer_norm(x)


class Wav2Vec2Model(nn.Module):
    """Waveforms [B, L] (and an optional [B, L] 0/1 sample mask) -> the last
    hidden state [B, T, hidden_size].  ``device`` defaults to the card and
    raises without one."""

    def __init__(self, cfg: Wav2Vec2Config, device=None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.feature_extractor = FeatureEncoder(cfg, device=device)
        self.feature_projection = FeatureProjection(cfg, device=device)
        self.masked_spec_embed = nn.Parameter(torch.rand(cfg.hidden_size, device=device))
        self.encoder = EncoderStableLayerNorm(cfg, device=device)

    def feature_mask(self, attention_mask: torch.Tensor, n_frames: int) -> torch.Tensor:
        """[B, L] sample mask -> [B, n_frames] bool: the first
        ``feat_extract_output_lengths(sum of the mask)`` frames of each item
        (Flax's ``_get_feature_vector_attention_mask``)."""
        lengths = feat_extract_output_lengths(attention_mask.sum(dim=-1), self.cfg)
        return torch.arange(n_frames, device=attention_mask.device)[None, :] < lengths[:, None]

    @torch.inference_mode()
    def forward(self, wav: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.feature_extractor(wav.float())
        mask = None if attention_mask is None else self.feature_mask(attention_mask, x.shape[1])
        return self.encoder(self.feature_projection(x), mask)


# --- a local checkpoint directory ------------------------------------------

# heads of a pretraining checkpoint (Wav2Vec2ForPreTraining) the model has no use for
PRETRAINING_HEADS = ("quantizer.", "project_q.", "project_hid.")
_WN_SPELLINGS = {"parametrizations.weight.original0": "weight_g",
                 "parametrizations.weight.original1": "weight_v"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as CPU tensors, parsed by hand: an 8-byte
    little-endian header size, a JSON header of ``{name: {dtype, shape,
    data_offsets}}``, then the raw little-endian data."""
    dtypes = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
              "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8,
              "BOOL": torch.bool}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        buf = bytearray(data[start:end])
        t = torch.frombuffer(buf, dtype=dtypes[meta["dtype"]]) if buf else torch.empty(
            0, dtype=dtypes[meta["dtype"]])
        out[name] = t.reshape(meta["shape"]).clone()
    return out


def normalize_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """HF checkpoint keys -> the model's: a ``wav2vec2.`` prefix stripped,
    ``parametrizations.weight.original0/1`` renamed ``weight_g``/``weight_v``,
    and the pretraining heads dropped, each one named."""
    out, dropped = {}, []
    for k, v in sd.items():
        if k.startswith("wav2vec2."):
            k = k[len("wav2vec2."):]
        if k.startswith(PRETRAINING_HEADS):
            dropped.append(k)
            continue
        for old, new in _WN_SPELLINGS.items():
            k = k.replace(old, new)
        out[k] = v
    if dropped:
        print(f"wav2vec2: dropped {len(dropped)} pretraining-head tensors: {', '.join(dropped)}")
    return out


def load_pretrained(model_dir: str, device=None) -> Wav2Vec2Model:
    """A local HF checkpoint directory (``config.json`` and
    ``pytorch_model.bin`` or ``model.safetensors``) -> ``Wav2Vec2Model`` in
    eval mode, loaded with ``strict=True``.  Nothing is fetched."""
    with open(os.path.join(model_dir, "config.json"), "r", encoding="utf-8") as f:
        cfg = Wav2Vec2Config.from_dict(json.load(f))
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    st_path = os.path.join(model_dir, "model.safetensors")
    if os.path.exists(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
    elif os.path.exists(st_path):
        sd = read_safetensors(st_path)
    else:
        raise FileNotFoundError(f"{model_dir}: neither pytorch_model.bin nor model.safetensors")
    model = Wav2Vec2Model(cfg, device=device)
    model.load_state_dict(normalize_state_dict(sd), strict=True)
    return model.eval()


def save_pretrained(model: Wav2Vec2Model, model_dir: str) -> None:
    """``config.json`` + ``pytorch_model.bin`` of ``model``, in HF's layout."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w", encoding="utf-8") as f:
        json.dump({**model.cfg.to_dict(), "model_type": "wav2vec2"}, f, indent=2)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(model_dir, "pytorch_model.bin"))


def random_model(cfg: Wav2Vec2Config, seed: int = 0, device=None) -> Wav2Vec2Model:
    """Seeded random weights (``torch.manual_seed(seed)`` on the CPU, so every
    device gets the same), in eval mode."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Wav2Vec2Model(cfg, device="cpu")
    return model.to(resolve_device(device)).eval()


def large_config() -> Wav2Vec2Config:
    """wav2vec 2.0 large with layer norm and stable layer norm, as
    ``chinese-wav2vec2-large`` is built: hidden 1024, 24 layers, 16 heads,
    FFN 4096, 7 x 512 convolutions with a bias."""
    return Wav2Vec2Config(
        hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True)

