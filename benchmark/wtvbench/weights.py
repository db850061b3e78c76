"""Seeded random weights, made on the device in a few large calls.

One standard-normal draw of every floating entry at once, from a
``torch.Generator`` on the device, is cut into the entries in sorted name
order and scaled by what each entry is:

* a kernel or matrix: ``x / sqrt(fan_in)`` (fan_in = all dims but the first);
* the character embedding: ``x`` (``nn.Embedding``'s N(0, 1));
* a norm's scale: ``1 + 0.1 x``; a bias: ``0.02 x``;
* BatchNorm statistics: mean ``0.1 x``, variance ``exp(0.2 x)``;
* a Conditional BatchNorm projection: ``1 + 0.02 x`` (HiFi-GAN's N(1, 0.02));
* spectral-norm vectors: ``x / ||x||``;
* a weight-norm gain: the norm of its direction, so the kernel is the
  direction itself;
* the position tables: the fixed sinusoid tables.

The duration predictor's output layer is set so that characters last
``duration_spread`` frames apart from one another, and near
``frames_per_char`` frames: its weights are scaled to that spread and
centred (they sum to 0), its bias is ``frames_per_char``, and the
LayerNorm before it is at unit scale and zero shift.  That puts the
output well inside the range where the ReLU after it is linear; the
exact mean is then set on the cell's own texts by
``common.set_duration_bias``, whose one shift of the bias is exact only
there.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

_DP = "length_regulator.duration_predictor."


def _kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "num_batches_tracked":
        return "count"
    if leaf == "running_mean":
        return "mean"
    if leaf == "running_var":
        return "var"
    if leaf == "weight_g":
        return "gain"
    if leaf in ("weight_u", "weight_v") and len(shape) == 1:
        return "unit"
    if name.endswith("src_word_emb.weight"):
        return "embedding"
    if ".cbns." in "." + name and leaf == "weight_orig":
        return "cbn"
    if len(shape) == 1:
        return "bias" if "bias" in leaf else "scale"
    return "kernel"


def make_state(shapes: Dict[str, tuple], seed: int, device,
               frozen: Optional[Dict[str, torch.Tensor]] = None,
               frames_per_char: Optional[float] = None,
               duration_spread: float = 1.5) -> Dict[str, torch.Tensor]:
    """A state dict of ``shapes`` drawn from ``seed`` on ``device`` (see the
    module docstring); ``frozen`` entries are taken as they are."""
    frozen = frozen or {}
    names = sorted(n for n in shapes if n not in frozen)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    for name, x in zip(names, torch.split(flat, sizes)):
        shape = shapes[name]
        x = x.reshape(shape)
        kind = _kind(name, shape)
        if kind == "count":
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        if kind == "mean":
            x = 0.1 * x
        elif kind == "var":
            x = torch.exp(0.2 * x)
        elif kind == "unit":
            x = x / torch.linalg.vector_norm(x)
        elif kind == "cbn":
            x = 1.0 + 0.02 * x
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        elif kind == "bias":
            x = 0.02 * x
        elif kind == "kernel":
            x = x / math.sqrt(max(1, math.prod(shape[1:])))
        out[name] = x.contiguous()
    for name in names:
        if _kind(name, shapes[name]) == "gain":
            v = out[name[: -len("weight_g")] + "weight_v"]
            dims = [d for d in range(v.dim()) if shapes[name][d] == 1]
            out[name] = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True))
    for name, t in frozen.items():
        out[name] = t.to(device)
    if frames_per_char is not None:
        w = out[_DP + "linear_layer.linear_layer.weight"]
        fs = w.shape[-1]
        # Var(relu(z)) of a unit normal is 0.34: the output's spread per character
        scale = duration_spread / math.sqrt(0.34 * fs)
        w = w * math.sqrt(fs)  # back to unit normal draws
        out[_DP + "linear_layer.linear_layer.weight"] = scale * (w - w.mean())
        out[_DP + "linear_layer.linear_layer.bias"] = torch.full((1,), float(frames_per_char),
                                                                device=device)
        out[_DP + "conv_layer.layer_norm_2.weight"] = torch.ones(fs, device=device)
        out[_DP + "conv_layer.layer_norm_2.bias"] = torch.zeros(fs, device=device)
    return out
