"""The grouped 1-D convolution repacked as one batched product per group
(JAX package: ops/tiled_conv.py ``mxu_grouped_conv1d``), the MSD's route
where ``Vec2WavConfig.msd_tiled_conv`` is set and the gate admits a layer.

The MSD's grouped layers (k = 41, groups 4 and 16; reference:
vec2wav/models.py:218-243) are products with 8-64 output channels a group,
too narrow for the matrix units, and cuDNN's strided grouped backward is the
largest single cost of the GAN step (``PERF.md`` section 5).  The repack
makes each row of the product yield R consecutive outputs of a group, so
that its width R * (Cout / G) reaches ~128.  For output block m and offset
r within it:

    out[b, g*co + n, m*R + r] = sum_{j, i} x_p[b, g*ci + i, m*s*R + r*s + j*d]
                                           * w[g*co + n, i, j]

which is one product per group between overlapping input tiles of
``n_rows * s * R`` samples, taken every ``s * R`` samples (``unfold``, a
strided view), and a weight expanded so that row ``r*s + j*d`` of column
block r holds ``w[..., j]``.  The expansion costs ``n_rows*s*R / k`` times
the operations (1.2-1.6x at the MSD's layers) and the tiles overlap, but
every product is a full-width matmul.  The gradients come from autograd:
the products' backwards are matmuls too, the tiles' is a scatter-add.

The sums are grouped ``F.conv1d``'s, in another order (plus zero terms).
Unlike the JAX module this one is not a TPU kernel's port: the JAX repack is
a plain XLA ``einsum``, and its product stays a library matmul here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

_TARGET_LANES = 128

def pick_r(cout_per_group: int, target: int = _TARGET_LANES) -> int:
    """Outputs a product row yields, so that its width reaches ~``target``."""
    return max(1, target // max(1, cout_per_group))


def tiled_conv_supported(kernel_size: int, stride: int, dilation: int, groups: int,
                         cout: int) -> bool:
    """Where the repack is taken (JAX package: ``tiled_conv_supported``):
    undilated, grouped, fewer than 128 outputs a group.  The JAX package
    also keeps inputs shorter than 16384 samples off it, a threshold of its
    TPU; on an H100 (80GB HBM3, 700 W; ``chip_smoke.py`` phase 35) the
    repack's forward + backward beat cuDNN's grouped one at every MSD layer
    and length measured (125-81920 samples), and the GAN step with the
    repack everywhere beat the step at JAX's threshold, so no length is
    kept off it here."""
    return (dilation == 1 and groups > 1 and cout % groups == 0
            and cout // groups < _TARGET_LANES and stride >= 1)


def tiled_grouped_conv1d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                         stride: int = 1, padding: int = 0, groups: int = 1,
                         dilation: int = 1) -> torch.Tensor:
    """``F.conv1d(x, w, bias, stride, padding, dilation, groups)`` over
    x [B, C, T] and w [Cout, C / groups, k] by the repack, ``pick_r``
    outputs a product row.  Computes in ``x``'s dtype; a bf16 product
    accumulates in f32, as JAX's ``preferred_element_type`` asks."""
    B, C, T = x.shape
    cout, ci, k = w.shape
    G, s, d = groups, stride, dilation
    if C != G * ci or cout % G:
        raise ValueError(f"grouped conv: x {tuple(x.shape)}, w {tuple(w.shape)}, groups {G}")
    co = cout // G
    k_eff = (k - 1) * d + 1                  # the dilated kernel's footprint
    R = pick_r(co)
    T_out = (T + 2 * padding - k_eff) // s + 1
    if T_out <= 0:
        raise ValueError(f"empty output: T={T} k={k} s={s} p={padding} d={d}")
    sR = s * R
    n_rows = math.ceil((k_eff + s * (R - 1)) / sR)  # whole sR-rows covering a tile's span
    n_tiles = math.ceil(T_out / R)
    width = n_rows * sR
    # the input, padded (or cut: F.pad crops on a negative side) to the
    # tiles' extent
    x_p = F.pad(x, (padding, (n_tiles - 1 + n_rows) * sR - T - padding))
    tiles = x_p.view(B, G, ci, -1).unfold(3, width, sR)  # [B, G, ci, n_tiles, width], a view
    a = tiles.permute(1, 0, 3, 2, 4).reshape(G, B * n_tiles, ci * width)
    # w_exp[g, i, r*s + j*d, r, n] = w[g*co + n, i, j]
    wg = w.view(G, co, ci, k).permute(0, 2, 3, 1)  # [G, ci, k, co]
    w_exp = w.new_zeros(G, ci, width, R, co)
    for rr in range(R):
        w_exp[:, :, rr * s:rr * s + k_eff:d, rr, :] = wg
    out = torch.bmm(a, w_exp.view(G, ci * width, R * co))  # [G, B * n_tiles, R * co]
    out = out.view(G, B, n_tiles * R, co).permute(1, 0, 3, 2).reshape(B, cout, n_tiles * R)
    out = out[:, :, :T_out]
    return out if bias is None else out + bias[:, None]
