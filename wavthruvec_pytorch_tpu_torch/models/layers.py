"""Building-block layers of the port (JAX package: models/layers.py).

Every layer takes and returns the JAX layout ``[B, T, C]`` (``[B, C]`` for
dense inputs) and transposes internally where ``F.conv1d`` wants
``[B, C, T]``.  Parameter and buffer names are the torch reference's, the
keys that ``weights.py`` emits, so state dicts load with ``strict=True``.
The discriminators' layers also take torch's layout: ``WNConv1d.conv`` and
``SpectralNormConv1d.conv`` ``[B, C, T]``, ``WNConv2d`` ``[B, C, H, W]``.
BatchNorm and spectral norm follow the module's train/eval mode: flax's
batch statistics, and one power iteration of spectral norm per training
forward (eval mode uses the stored ``u``, ``v`` without iterating).

Compute dtype, flax's rule (``dtype`` of ``nn.Dense``, ``nn.Conv``,
``nn.LayerNorm``, ``nn.BatchNorm``): a layer built with ``dtype`` casts its
input and its f32 parameters to it and returns that dtype; with ``dtype=None``
it computes in the promotion of its input's and parameters' dtypes (bf16
input and f32 parameters: f32).  Parameters stay f32 and their gradients
reach them in f32 through the casts.  The normalisations take their
statistics in f32 whatever the dtype.  A product and its bias add are two
roundings, as in flax.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from wavthruvec_pytorch_tpu_torch.ops.gru import GRURecurrence
from wavthruvec_pytorch_tpu_torch.ops.tiled_conv import tiled_conv_supported, tiled_grouped_conv1d

_GAIN = {"linear": 1.0, "relu": math.sqrt(2.0), "tanh": 5.0 / 3.0, "sigmoid": 1.0}

def compute_dtype(dtype, x: torch.Tensor, *params) -> torch.dtype:
    """flax's rule: ``dtype`` if given, else the promotion of the input's and
    the parameters' dtypes."""
    if dtype is not None:
        return dtype
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return dt


def _casts(dtype, x, *params) -> bool:
    """Whether the layer must cast: a dtype is given, or its input's and
    parameters' dtypes differ.  Otherwise the one-call path of before runs."""
    return dtype is not None or any(p is not None and p.dtype != x.dtype for p in params)


def dense(x: torch.Tensor, weight: torch.Tensor, bias, dtype=None) -> torch.Tensor:
    """flax ``nn.Dense(dtype)`` with a torch-layout weight [out, in]."""
    if not _casts(dtype, x, weight, bias):
        return F.linear(x, weight, bias)
    dt = compute_dtype(dtype, x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


class TorchLinear(nn.Linear):
    """nn.Linear with torch's default init (JAX: ``TorchLinear``) and a
    compute ``dtype`` (None: promote)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None,
                 device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


class Linear(nn.Module):
    """nn.Linear with xavier_uniform(gain) weights, kept under the
    reference's ``linear_layer`` attribute (text2vec/subLayer.py:11-31)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 w_init_gain: str = "linear", dtype=None, device=None):
        super().__init__()
        self.linear_layer = TorchLinear(in_features, out_features, bias=bias, dtype=dtype,
                                        device=device)
        nn.init.xavier_uniform_(self.linear_layer.weight, gain=_GAIN[w_init_gain])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_layer(x)


class Conv1d(nn.Conv1d):
    """torch Conv1d over ``[B, T, C]`` (optionally xavier-initialised) with a
    compute ``dtype`` (None: promote)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = True, w_init_gain: str | None = None, dtype=None, device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias, device=device)
        if w_init_gain is not None:
            nn.init.xavier_uniform_(self.weight, gain=_GAIN[w_init_gain])
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _casts(self.compute_dtype, x, self.weight, self.bias):
            return super().forward(x.transpose(1, 2)).transpose(1, 2)
        dt = compute_dtype(self.compute_dtype, x, self.weight, self.bias)
        y = F.conv1d(x.transpose(1, 2).to(dt), self.weight.to(dt), None, self.stride,
                     self.padding, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None]
        return y.transpose(1, 2)


class PartialConv1d(Conv1d):
    """Partial-padding Conv1d over ``[B, T, C]`` (JAX package:
    models/layers.py ``PartialConv1d``; reference: text2vec/module.py:366-418):
    an output whose window overlaps the zero padding, or masked-out frames,
    is rescaled by ``kernel_size / coverage``, and one whose window covers
    nothing is zeroed.  The ``1e-6`` in the denominator is the reference's,
    so interior outputs carry a ``k / (k + 1e-6)`` factor too.  Its
    parameters are Conv1d's (``weight``, ``bias``), so state dicts load
    either way; it computes in f32 (ConvAttention's dtype)."""

    def forward(self, x: torch.Tensor, mask_in: torch.Tensor | None = None) -> torch.Tensor:
        """x [B, T, C]; mask_in [B, T] or [B, T, 1] (1 where valid) or None."""
        if mask_in is not None and mask_in.dim() == 2:
            mask_in = mask_in[..., None]
        k, = self.kernel_size
        # each output's coverage: the mask (or ones) convolved with a ones kernel
        ones = (x.new_ones((1, 1, x.shape[1])) if mask_in is None
                else mask_in.to(x.dtype).transpose(1, 2))
        coverage = F.conv1d(ones, x.new_ones((1, 1, k)), None, self.stride, self.padding,
                            self.dilation).transpose(1, 2)  # [B or 1, T_out, 1]
        update_mask = coverage.clamp(0.0, 1.0)
        mask_ratio = k / (coverage + 1e-6) * update_mask
        if mask_in is not None:
            x = x * mask_in.to(x.dtype)
        out = F.conv1d(x.transpose(1, 2), self.weight, None, self.stride, self.padding,
                       self.dilation).transpose(1, 2) * mask_ratio
        if self.bias is not None:
            out = (out + self.bias) * update_mask
        return out


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim with torch's eps 1e-5 and a compute
    ``dtype`` (None: promote): statistics and normalisation in f32, the
    result cast to the dtype."""

    def __init__(self, normalized_shape: int, dtype=None, device=None):
        super().__init__(normalized_shape, eps=1e-5, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not _casts(self.compute_dtype, x, self.weight, self.bias):
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(compute_dtype(self.compute_dtype, x, self.weight, self.bias))


class BatchNorm(nn.Module):
    """BatchNorm1d over the last dim of ``[B, T, C]`` or ``[B, C]``, eps
    1e-5, with torch BatchNorm1d's parameter and buffer names and flax
    ``nn.BatchNorm``'s semantics (JAX package: models/layers.py:283-309).

    In eval mode it normalises with the running statistics.  In train mode
    it normalises with the batch's mean and its biased variance
    ``max(0, E[x^2] - E[x]^2)`` (flax's ``use_fast_variance``), and moves the
    running statistics 0.1 of the way to them, the variance biased too.
    ``F.batch_norm(training=True)`` would update with the unbiased variance.
    ``momentum`` is flax's: the running statistics keep 0.9 of themselves a
    step (``infer.recalibrate`` reads it here).
    """

    momentum = 0.9

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5,
                 dtype=None, device=None):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features, device=device))
            self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        else:
            self.weight = None
            self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            xf = x.float()  # flax takes the statistics in f32
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                # flax's update: ra = m * ra + (1 - m) * stat
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x - mean) * mul
        if self.bias is not None:
            y = y + self.bias
        return y.to(compute_dtype(self.compute_dtype, x, self.weight, self.bias))


class Highway(nn.Module):
    """Highway layer (reference: text2vec/module.py:247-260): H bias zeroed,
    T (gate) bias at -1.  As in the JAX package it has no compute dtype: its
    Dense layers promote."""

    def __init__(self, in_size: int, out_size: int, device=None):
        super().__init__()
        self.H = nn.Linear(in_size, out_size, device=device)
        self.T = nn.Linear(in_size, out_size, device=device)
        nn.init.zeros_(self.H.bias)
        nn.init.constant_(self.T.bias, -1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(dense(x, self.H.weight, self.H.bias))
        t = torch.sigmoid(dense(x, self.T.weight, self.T.bias))
        return h * t + x * (1.0 - t)


def _norm_except(v: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm of ``v`` over every dim but ``dim`` (kept), with the JAX
    package's 1e-32 under the root (models/layers.py:341-346)."""
    dims = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-32)


def cast_conv(conv, x: torch.Tensor, w: torch.Tensor, bias, dt, **kw) -> torch.Tensor:
    """``conv(x, w, **kw)`` with input and kernel cast to the compute dtype
    ``dt``, then the bias add in ``dt``: flax's two roundings (``dt`` None:
    as given, the bias in the call).  On the CPU a bf16 product runs in f32
    on the bf16-rounded operands and rounds its result, as XLA's CPU
    computes it: the same roundings, forward and backward, and oneDNN's bf16
    grouped weight gradient can come back NaN where the window lies mostly
    in the padding."""
    if dt is None:
        return conv(x, w, bias, **kw)
    x, w = x.to(dt), w.to(dt)
    if x.device.type == "cpu" and dt == torch.bfloat16:
        y = conv(x.float(), w.float(), **kw).to(dt)
    else:
        y = conv(x, w, **kw)
    if bias is None:
        return y
    return y + bias.to(dt).view(-1, *([1] * (y.dim() - 2)))


def conv1d(x: torch.Tensor, w: torch.Tensor, bias, dtype=None, tiled: bool = False,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """``F.conv1d`` over [B, C, T] in the compute ``dtype`` (flax's
    two roundings, product then bias; None: as given, the bias in the
    call), through the repack ``ops.tiled_conv.tiled_grouped_conv1d`` where
    ``tiled`` is set and its gate admits the layer (JAX package:
    models/layers.py ``_conv1d_impl``)."""
    conv = F.conv1d
    if tiled and tiled_conv_supported(w.shape[2], stride, dilation, groups, w.shape[0]):
        conv = tiled_grouped_conv1d
    return cast_conv(conv, x, w, bias, dtype, stride=stride, padding=padding,
                     dilation=dilation, groups=groups)


class WNConv1d(nn.Module):
    """weight_norm(Conv1d) over ``[B, T, C]`` (``conv``: over ``[B, C, T]``):
    ``weight_g`` [out, 1, 1], ``weight_v`` [out, in / groups, k], ``bias``
    [out]; the norm is per output channel.  ``w_std`` selects HiFi-GAN's
    N(0, w_std) init of ``v``; ``g`` starts at ``||v||``.

    ``folded`` (JAX: ``WNConv1d(folded=True)``): ``weight_v`` already holds
    the normed kernel (``models.vec2wav.fold_weight_norm``) and is used as
    it is.  ``dtype`` casts the input, kernel and bias to it, with the bias
    added after the product (flax's two roundings).  ``tiled``: the grouped
    repack where its gate admits the layer (``conv1d``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 w_std: float | None = None, stride: int = 1, groups: int = 1,
                 folded: bool = False, dtype=None, tiled: bool = False, device=None):
        super().__init__()
        self.padding = padding
        self.dilation = dilation
        self.stride = stride
        self.groups = groups
        self.folded = folded
        self.compute_dtype = dtype
        self.tiled = tiled
        fan_in = in_channels // groups * kernel_size
        v = torch.empty(out_channels, in_channels // groups, kernel_size, device=device)
        if w_std is not None:
            nn.init.normal_(v, 0.0, w_std)
        else:
            nn.init.uniform_(v, -1.0 / math.sqrt(fan_in), 1.0 / math.sqrt(fan_in))
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(_norm_except(v, 0).clone())
        if bias:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias = nn.Parameter(
                torch.empty(out_channels, device=device).uniform_(-bound, bound))
        else:
            self.bias = None

    def weight(self) -> torch.Tensor:
        """The weight-normed kernel g * v / ||v|| (``v`` itself when
        ``folded``), torch layout [out, in / groups, k]."""
        if self.folded:
            return self.weight_v
        return self.weight_g * self.weight_v / _norm_except(self.weight_v, 0)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C_in, T] -> [B, C_out, T_out]."""
        return conv1d(x, self.weight(), self.bias, self.compute_dtype, self.tiled,
                      stride=self.stride, padding=self.padding, dilation=self.dilation,
                      groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2).contiguous()


class WNConv2d(nn.Module):
    """weight_norm(Conv2d) over ``[B, C, H, W]`` (the MPD's stacks; JAX
    package: models/layers.py ``WNConv2d``, which takes NHWC): ``weight_g``
    [out, 1, 1, 1], ``weight_v`` [out, in, kh, kw], ``bias`` [out]; the norm
    is over (in, kh, kw) for each output channel.  ``dtype`` as in
    ``WNConv1d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), dtype=None, device=None):
        super().__init__()
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.compute_dtype = dtype
        kh, kw = kernel_size
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        v = torch.empty(out_channels, in_channels, kh, kw, device=device).uniform_(-bound, bound)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(_norm_except(v, 0).clone())
        self.bias = nn.Parameter(torch.empty(out_channels, device=device).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_g * self.weight_v / _norm_except(self.weight_v, 0)
        return cast_conv(F.conv2d, x, w, self.bias, self.compute_dtype, stride=self.stride,
                         padding=self.padding)


class WNConvTranspose1d(nn.Module):
    """weight_norm(ConvTranspose1d) over ``[B, T, C]``: ``weight_g`` [in, 1, 1],
    ``weight_v`` [in, out, k]; output length ``(T-1)*stride - 2*padding + k``.
    ``folded`` and ``dtype`` as in ``WNConv1d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, w_std: float = 0.01,
                 folded: bool = False, dtype=None, device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.folded = folded
        self.compute_dtype = dtype
        v = torch.empty(in_channels, out_channels, kernel_size, device=device)
        nn.init.normal_(v, 0.0, w_std)
        self.weight_v = nn.Parameter(v)
        self.weight_g = nn.Parameter(_norm_except(v, 0).clone())
        bound = 1.0 / math.sqrt(in_channels * kernel_size)
        self.bias = nn.Parameter(
            torch.empty(out_channels, device=device).uniform_(-bound, bound))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight_v
        if not self.folded:
            w = self.weight_g * w / _norm_except(w, 0)
        y = cast_conv(F.conv_transpose1d, x.transpose(1, 2), w, self.bias, self.compute_dtype,
                      stride=self.stride, padding=self.padding)
        return y.transpose(1, 2).contiguous()


def _l2n(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / max(||v||, eps)`` (JAX package: models/layers.py ``_l2n``)."""
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


class _SpectralNorm(nn.Module):
    """spectral_norm's state and sigma: ``weight_orig``, ``bias`` and the
    buffers ``weight_u`` [out], ``weight_v`` [numel / out].  In train mode each
    call takes one power iteration from the stored vectors, ``v <- n(W^T u)``,
    ``u <- n(W v)``, and stores the new ones; in eval mode it uses the stored
    ones.  sigma = u . (W v), with u and v out of the graph and W in it
    (JAX package: models/layers.py:567-700)."""

    def _init_vectors(self, out_features: int, dim_v: int, device) -> None:
        self.register_buffer("weight_u", _l2n(torch.randn(out_features, device=device)))
        self.register_buffer("weight_v", _l2n(torch.randn(dim_v, device=device)))

    def sigma(self) -> torch.Tensor:
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        if self.training:
            with torch.no_grad():
                v = _l2n(torch.mv(w.t(), self.weight_u))
                u = _l2n(torch.mv(w, v))
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        else:
            # clones: a later training call updates the buffers in place
            u, v = self.weight_u.clone(), self.weight_v.clone()
        return torch.dot(u, torch.mv(w, v))


class SpectralNormDense(_SpectralNorm):
    """spectral_norm(Linear): ``weight_orig`` [out, in] / sigma."""

    def __init__(self, in_features: int, out_features: int,
                 w_mean: float = 0.0, w_std: float | None = None, device=None):
        super().__init__()
        w = torch.empty(out_features, in_features, device=device)
        if w_std is None:
            bound = 1.0 / math.sqrt(in_features)
            nn.init.uniform_(w, -bound, bound)
        else:
            nn.init.normal_(w, w_mean, w_std)
        self.weight_orig = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self._init_vectors(out_features, in_features, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight_orig / self.sigma(), self.bias)


class SpectralNormConv1d(_SpectralNorm):
    """spectral_norm(Conv1d) (the MSD's first scale): ``weight_orig``
    [out, in / groups, k], its power iteration over the weight as
    [out, in / groups * k].  ``forward`` takes ``[B, T, C]``, ``conv``
    ``[B, C, T]``.  ``dtype`` and ``tiled`` as in ``WNConv1d``: the
    normalised kernel is cast, sigma stays f32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, dtype=None, tiled: bool = False,
                 device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.groups = groups
        self.compute_dtype = dtype
        self.tiled = tiled
        bound = 1.0 / math.sqrt(in_channels // groups * kernel_size)
        w = torch.empty(out_channels, in_channels // groups, kernel_size, device=device)
        self.weight_orig = nn.Parameter(w.uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device).uniform_(-bound, bound))
        self._init_vectors(out_channels, in_channels // groups * kernel_size, device)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.weight_orig / self.sigma(), self.bias, self.compute_dtype,
                      self.tiled, stride=self.stride, padding=self.padding, groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2).contiguous()


class BiGRU(nn.Module):
    """Bidirectional single-layer GRU over ``[B, T, C]`` -> ``[B, T, 2H]``
    with torch nn.GRU's gate math and parameter names.

    It computes what the JAX package's ``gru_impl="pallas"`` path computes:
    the input projections in f32 by one matmul, then the recurrence through
    ``ops.gru.GRURecurrence``, whose forward is ``gru_fwd`` with ``w_hh``
    rounded to bf16 and h carried in f32 (on a CUDA tensor the hand-written
    kernel, on a CPU tensor its plain version) and whose backward is JAX's
    custom VJP.  The backward direction runs over ``flip(x)`` across the whole
    padded length with no length masking, as the reference feeds the padded
    sequence unpacked (text2vec/module.py:356-358), and its output is flipped
    back.
    """

    def __init__(self, input_size: int, hidden_size: int, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        H3 = 3 * hidden_size
        for sfx in ("", "_reverse"):
            for name, shape in ((f"weight_ih_l0{sfx}", (H3, input_size)),
                                (f"weight_hh_l0{sfx}", (H3, hidden_size)),
                                (f"bias_ih_l0{sfx}", (H3,)),
                                (f"bias_hh_l0{sfx}", (H3,))):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, device=device).uniform_(-bound, bound)))

    def recurrence_inputs(self, x: torch.Tensor):
        """[B, T, C] -> the arguments of ``GRURecurrence`` for both
        directions: gi [2, B, T, 3H] f32, w_hh [2, H, 3H] f32 (a transposed
        view of the parameters), b_hh [2, 3H] f32."""
        B, T, C = x.shape
        H3 = 3 * self.hidden_size
        xs = torch.stack([x, torch.flip(x, dims=(1,))])  # [2, B, T, C]
        w_ih = torch.stack([self.weight_ih_l0, self.weight_ih_l0_reverse])  # [2, 3H, C]
        b_ih = torch.stack([self.bias_ih_l0, self.bias_ih_l0_reverse])
        # JAX's einsum promotes a bf16 input with the f32 weights to f32
        xs = xs.to(compute_dtype(None, xs, w_ih))
        gi = torch.matmul(xs.reshape(2, B * T, C), w_ih.transpose(1, 2))
        gi = (gi.reshape(2, B, T, H3) + b_ih[:, None, None]).contiguous()
        # JAX layout [D, H, 3H]: a transposed view of torch's [D, 3H, H]
        w_hh = torch.stack([self.weight_hh_l0, self.weight_hh_l0_reverse])
        b_hh = torch.stack([self.bias_hh_l0, self.bias_hh_l0_reverse]).contiguous()
        return gi, w_hh.transpose(1, 2), b_hh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = GRURecurrence.apply(*self.recurrence_inputs(x))  # [2, B, T, H]
        return torch.cat([ys[0], torch.flip(ys[1], dims=(1,))], dim=-1)
