"""The MSD's grouped-convolution repack (``ops/tiled_conv.py``) against
grouped ``F.conv1d`` and the JAX package's ``mxu_grouped_conv1d`` on the
CPU, its gate, and the port's MSD on the repack against JAX's.

Tolerances (f32 on both sides; the repack sums the same products plus zero
terms in another order): values within 1e-5 of the output's largest
magnitude, the input and weight gradients within 1e-4 of each gradient's
largest magnitude; the MSD's scores and feature maps atol 2e-4, the port's
MSD tolerance (``tests/test_torch_gan.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests.test_torch_gan import _compare_outputs, _np, _t, _waves
from wavthruvec_pytorch_tpu.checkpoint import import_vec2wav_msd
from wavthruvec_pytorch_tpu.models import vec2wav as jv
from wavthruvec_pytorch_tpu.ops import tiled_conv as jtiled
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models import vec2wav as tv
from wavthruvec_pytorch_tpu_torch.ops.tiled_conv import tiled_conv_supported, tiled_grouped_conv1d
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

# (B, T, G, ci, co, k, s, p, d): the JAX module's 8 self-test shapes
# (ops/tiled_conv.py:144-153), then the MSD's grouped layers 2-5 at short
# lengths (layer 1, 128 -> 128 in 4 groups, is the first shape)
SHAPES = [
    (2, 203, 4, 32, 32, 41, 2, 20, 1),
    (2, 101, 16, 8, 16, 41, 2, 20, 1),
    (1, 57, 16, 16, 32, 41, 4, 20, 1),
    (2, 64, 2, 4, 8, 5, 1, 2, 1),
    (1, 33, 3, 5, 7, 9, 3, 4, 1),
    (2, 80, 1, 1, 128, 15, 1, 7, 1),
    (2, 96, 1, 32, 32, 3, 1, 3, 3),
    (1, 50, 2, 8, 16, 5, 2, 6, 2),
    (2, 96, 16, 8, 16, 41, 2, 20, 1),
    (2, 64, 16, 16, 32, 41, 4, 20, 1),
    (2, 40, 16, 32, 64, 41, 4, 20, 1),
    (2, 24, 16, 64, 64, 41, 1, 20, 1),
]


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_repack_matches_grouped_conv_and_jax(shape):
    """Values and both gradients (the same cotangent) against grouped
    ``F.conv1d`` with autograd and against JAX's repack with ``jax.vjp``."""
    B, T, G, ci, co, k, s, p, d = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, G * ci, T)).astype(np.float32)
    w = rng.standard_normal((G * co, ci, k)).astype(np.float32)
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = tiled_grouped_conv1d(xt, wt, None, s, p, G, d)
    want = F.conv1d(xt, wt, None, s, p, d, G)
    assert got.shape == want.shape
    cot = rng.standard_normal(tuple(want.shape)).astype(np.float32)
    g_got = torch.autograd.grad(got, (xt, wt), torch.tensor(cot))
    g_want = torch.autograd.grad(want, (xt, wt), torch.tensor(cot))
    # JAX: [B, T, C] and the HIO kernel [k, ci, Cout]
    @jax.jit
    def jax_vjp(a, b, c):
        out, vjp = jax.vjp(lambda a_, b_: jtiled.mxu_grouped_conv1d(a_, b_, s, p, G, dilation=d),
                           a, b)
        return (out,) + vjp(c)

    j_out, jgx, jgw = jax_vjp(*(jnp.asarray(a.transpose(t)) for a, t in (
        (x, (0, 2, 1)), (w, (2, 1, 0)), (cot, (0, 2, 1)))))
    out = got.detach().numpy()
    assert _scaled_err(out, want.detach().numpy()) <= 1e-5
    assert _scaled_err(out, np.asarray(j_out).transpose(0, 2, 1)) <= 1e-5
    for g, gw, jg in zip(g_got, g_want, (np.asarray(jgx).transpose(0, 2, 1),
                                         np.asarray(jgw).transpose(2, 1, 0))):
        assert _scaled_err(g.numpy(), gw.numpy()) <= 1e-4
        assert _scaled_err(g.numpy(), jg) <= 1e-4


def test_repack_bias_and_shape_check():
    """The bias joins after the product; a kernel of the wrong width for
    its groups raises."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 64, 150)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((128, 4, 41)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal(128), dtype=torch.float32)
    want = F.conv1d(x, w, b, 2, 20, 1, 16)
    got = tiled_grouped_conv1d(x, w, b, stride=2, padding=20, groups=16)
    assert _scaled_err(got.numpy(), want.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="groups"):
        tiled_grouped_conv1d(x, w[:, :3], None, 2, 20, 16)


@pytest.mark.parametrize("args,want", [
    ((41, 2, 1, 16, 256), True),
    ((41, 2, 1, 16, 256, 80000), True),
    ((41, 2, 1, 16, 256, 8000), False),  # short input
    ((41, 2, 1, 1, 128), False),         # dense
    ((41, 2, 2, 16, 256), False),        # dilated
    ((41, 2, 1, 2, 512), False),         # 256 outputs a group
])
def test_gate(args, want):
    """The cases of ``tests/test_ops.py``: the port's gate answers as JAX's
    does on every clause but JAX's input length (16384 samples, a TPU
    threshold); the port keeps no length off the repack (measured on the
    card), so a short input is admitted too."""
    assert jtiled.tiled_conv_supported(*args) is want
    assert jtiled.MIN_T_IN == 16384
    short = len(args) == 6 and args[5] < jtiled.MIN_T_IN
    assert tiled_conv_supported(*args[:5]) is (want or short)


@pytest.fixture(scope="module")
def msd_vars():
    """A seeded port MSD's weights, imported into JAX by its own importer."""
    torch.manual_seed(5)
    sd = tv.MultiScaleDiscriminator(device="cpu").state_dict()
    return _np(import_vec2wav_msd({k: v.numpy() for k, v in sd.items()}))


def test_msd_on_the_repack_matches_jax(msd_vars, monkeypatch):
    """JAX's length threshold set to 0, as ``tests/test_models.py`` sets
    it (the port has none): the port's MSD with ``tiled_conv`` against
    JAX's ``MultiScaleDiscriminator(tiled_conv=True)`` in train mode, the
    spectral vectors updated; the repack ran on every grouped layer of
    every scale (5 a scale, pair-batched), both the spectral-normed first
    scale and the weight-normed ones."""
    monkeypatch.setattr(jtiled, "MIN_T_IN", 0)
    calls = []
    monkeypatch.setattr(tl, "tiled_grouped_conv1d",
                        lambda *a, **k: calls.append(a[1].shape) or tiled_grouped_conv1d(*a, **k))
    y, y_hat = _waves()
    jmsd = jv.MultiScaleDiscriminator(tiled_conv=True, pair_batched=True)
    want, _ = jax.jit(lambda v, a, b: jmsd.apply(v, a, b, mutable=["spectral"]))(
        msd_vars, jnp.asarray(y), jnp.asarray(y_hat))
    tmsd = tv.MultiScaleDiscriminator(True, tiled_conv=True, device="cpu").train()
    tmsd.load_state_dict(weights.msd_state_dict(msd_vars), strict=True)
    assert _compare_outputs(tmsd(_t(y), _t(y_hat)), want, (0, 2, 1)) == 2 * 3 * 8
    assert len(calls) == 3 * 5
    # without tiled_conv: no repack
    tmsd = tv.MultiScaleDiscriminator(True, device="cpu").train()
    tmsd.load_state_dict(weights.msd_state_dict(msd_vars), strict=True)
    calls.clear()
    tmsd(_t(y), _t(y_hat))
    assert not calls


def test_trainer_routes_the_msd_by_its_flag():
    """``GANTrainer`` builds the MSD with ``cfg.msd_tiled_conv`` (the JAX
    default, on), as JAX ``init_state`` does; the dense layers never take
    the repack."""
    small = dict(n_feat_dim=8, num_wv_feat=8, spk_dim=4, noise_dim=4,
                 upsample_initial_channel=8, upsample_rates=(2,), upsample_kernel_sizes=(4,),
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),), periods=(2,))
    for flag in (True, False):
        cfg = dataclasses.replace(Vec2WavConfig(**small), msd_tiled_conv=flag)
        msd = GANTrainer(cfg, device="cpu").msd
        for d in msd.discriminators:
            assert [c.tiled for c in d.convs] == [flag] * len(d.convs)
            assert not d.conv_post.tiled
    assert Vec2WavConfig().msd_tiled_conv
