"""The port's GAN modules against the JAX package's on the CPU: the
spectral-norm and 2-D weight-norm layers, both discriminators, the
train-mode Generator and the losses.  The same numpy inputs go through
both; JAX weights are carried into the port by ``weights.py``.

Tolerances (f32 on both sides, sums in another order): layers' outputs and
updated u, v atol 1e-5; MPD and MSD scores and every feature map atol 2e-4,
the JAX package's Generator/MPD/MSD torch-parity tolerance
(tests/test_reference_parity.py:115, 146-150), their spectral vectors atol
1e-5; the train-mode Generator's waveform atol 2e-4 and its new BatchNorm
statistics and spectral vectors atol 1e-5; the losses rtol 1e-6.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavthruvec_pytorch_tpu import checkpoint as ckpt
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu.models import vec2wav as jv
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models import vec2wav as tv
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import fused_conv_residual
from wavthruvec_pytorch_tpu_torch.train import vec2wav_loop
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V2W_SMALL = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=8, noise_dim=8,
                 upsample_initial_channel=32, upsample_rates=(4, 4),
                 upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 2), (1, 2)))
PERIODS = (13, 17, 19)  # the full config's
L_WAV = 200  # samples: past every period, and no multiple of any


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.array(a))


# --- layers -----------------------------------------------------------------

def test_wnconv2d():
    """WNConv2d (NCHW) against JAX's (NHWC), the MPD's first-layer shape."""
    rng = np.random.default_rng(0)
    x = _rand(rng, (2, 30, 7, 6))  # [B, H, W, C]
    m = jl.WNConv2d(16, kernel_size=(5, 1), strides=(3, 1), padding=(2, 0))
    v = _np(m.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    v["g"] = v["g"] * rng.uniform(0.5, 1.5, v["g"].shape).astype(np.float32)
    want = np.asarray(m.apply({"params": v}, jnp.asarray(x)))
    t = tl.WNConv2d(6, 16, (5, 1), (3, 1), (2, 0))
    t.load_state_dict({"weight_v": _t(np.transpose(v["v"], (3, 2, 0, 1))),
                       "weight_g": _t(np.transpose(v["g"], (3, 2, 0, 1))),
                       "bias": _t(v["bias"])}, strict=True)
    got = t(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _spectral_case(jmod, tmod, x, to_torch):
    """Both layers from JAX's weights and vectors, two train-mode calls (two
    power iterations), then one eval-mode call: outputs and vectors."""
    jvars = _np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    sd = {k: _t(a) for k, a in to_torch(jvars).items()}
    tmod.load_state_dict(sd, strict=True)
    spectral = jvars["spectral"]
    for _ in range(2):
        want, mut = jmod.apply({"params": jvars["params"], "spectral": spectral},
                               jnp.asarray(x), mutable=["spectral"])
        spectral = _np(mut["spectral"])
        got = tmod.train()(_t(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(tmod.weight_u.numpy(), spectral["u"], atol=1e-5)
        np.testing.assert_allclose(tmod.weight_v.numpy(), spectral["v"], atol=1e-5)
    frozen = jmod.clone(update_stats=False)
    want = frozen.apply({"params": jvars["params"], "spectral": spectral}, jnp.asarray(x))
    u = tmod.weight_u.clone()
    got = tmod.eval()(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert torch.equal(tmod.weight_u, u)  # eval mode does not iterate


def test_spectral_norm_dense_train_mode():
    rng = np.random.default_rng(1)
    x = _rand(rng, (3, 12))
    _spectral_case(jl.SpectralNormDense(20), tl.SpectralNormDense(12, 20), x,
                   lambda v: {"weight_orig": v["params"]["kernel"].T, "bias": v["params"]["bias"],
                              "weight_u": v["spectral"]["u"], "weight_v": v["spectral"]["v"]})


def test_spectral_norm_conv1d_train_mode():
    """Grouped, strided, k = 41: the MSD's second layer at narrower widths."""
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 90, 16))
    _spectral_case(
        jl.SpectralNormConv1d(32, kernel_size=41, stride=2, groups=4, padding=20),
        tl.SpectralNormConv1d(16, 32, 41, stride=2, padding=20, groups=4), x,
        lambda v: {"weight_orig": np.transpose(v["params"]["kernel"], (2, 1, 0)),
                   "bias": v["params"]["bias"], "weight_u": v["spectral"]["u"],
                   "weight_v": v["spectral"]["v"]})


# --- discriminators ---------------------------------------------------------

def _waves(seed=3, B=2):
    rng = np.random.default_rng(seed)
    return _rand(rng, (B, L_WAV, 1), 0.3), np.tanh(_rand(rng, (B, L_WAV, 1)))


def _compare_outputs(got, want, fmap_layout):
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = got
    for g_list, w_list in ((y_d_rs, want[0]), (y_d_gs, want[1])):
        assert len(g_list) == len(w_list)
        for g, w in zip(g_list, w_list):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=2e-4)
    n = 0
    for g_maps, w_maps in ((fmap_rs, want[2]), (fmap_gs, want[3])):
        for g_d, w_d in zip(g_maps, w_maps):
            assert len(g_d) == len(w_d)
            for g, w in zip(g_d, w_d):
                np.testing.assert_allclose(g.detach().permute(*fmap_layout).numpy(),
                                           np.asarray(w), atol=2e-4)
                n += 1
    return n


@pytest.fixture(scope="module")
def mpd_vars():
    y, y_hat = _waves()
    cfg = JV2W(periods=PERIODS)
    jmpd = jv.MultiPeriodDiscriminator(cfg)
    return _np(jmpd.init(jax.random.PRNGKey(4), jnp.asarray(y), jnp.asarray(y_hat)))


@pytest.mark.parametrize("pair_batched", [True, False])
def test_mpd(mpd_vars, pair_batched):
    """Periods 13, 17, 19 over 200 samples (each reflect-padded): the scores
    and all 18 feature maps."""
    y, y_hat = _waves()
    cfg = JV2W(periods=PERIODS)
    jmpd = jv.MultiPeriodDiscriminator(cfg, pair_batched=pair_batched)
    want = jmpd.apply(mpd_vars, jnp.asarray(y), jnp.asarray(y_hat))
    tmpd = tv.MultiPeriodDiscriminator(Vec2WavConfig(periods=PERIODS), pair_batched,
                                       device="cpu")
    tmpd.load_state_dict(weights.mpd_state_dict(mpd_vars, cfg), strict=True)
    n = _compare_outputs(tmpd(_t(y), _t(y_hat)), want, (0, 2, 3, 1))
    assert n == 2 * 3 * 6


@pytest.fixture(scope="module")
def msd_vars():
    y, y_hat = _waves()
    jmsd = jv.MultiScaleDiscriminator()
    return _np(jmsd.init(jax.random.PRNGKey(5), jnp.asarray(y), jnp.asarray(y_hat)))


@pytest.mark.parametrize("pair_batched", [True, False])
def test_msd(msd_vars, pair_batched):
    """Three scales over 200, 101 and 51 samples, spectral updates on (train
    mode): the scores, all 24 feature maps, and the first scale's u, v after
    two MSD calls (one power iteration a call with ``pair_batched``, two
    without)."""
    y, y_hat = _waves()
    jmsd = jv.MultiScaleDiscriminator(pair_batched=pair_batched)
    tmsd = tv.MultiScaleDiscriminator(pair_batched, device="cpu").train()
    tmsd.load_state_dict(weights.msd_state_dict(msd_vars), strict=True)
    spectral = msd_vars["spectral"]
    for _ in range(2):
        want, mut = jmsd.apply({"params": msd_vars["params"], "spectral": spectral},
                               jnp.asarray(y), jnp.asarray(y_hat), mutable=["spectral"])
        spectral = _np(mut["spectral"])
        n = _compare_outputs(tmsd(_t(y), _t(y_hat)), want, (0, 2, 1))
        assert n == 2 * 3 * 8
    sd = tmsd.state_dict()
    for key, w in weights.msd_state_dict({"params": msd_vars["params"],
                                          "spectral": spectral}).items():
        if key.endswith(("weight_u", "weight_v")):
            torch.testing.assert_close(sd[key], w, atol=1e-5, rtol=0, msg=key)


def test_discriminator_state_dicts_equal_exporters(mpd_vars, msd_vars):
    """``mpd_state_dict`` / ``msd_state_dict``: the keys and values of the
    JAX package's ``export_vec2wav_mpd`` / ``export_vec2wav_msd``, exactly."""
    cfg = JV2W(periods=PERIODS)
    pairs = ((weights.mpd_state_dict(mpd_vars, cfg), ckpt.export_vec2wav_mpd(mpd_vars, cfg)),
             (weights.msd_state_dict(msd_vars), ckpt.export_vec2wav_msd(msd_vars)))
    for got, want in pairs:
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


# --- the Generator ----------------------------------------------------------

def _generator_inputs(cfg, B=2, T=11, seed=6):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (B, T, cfg.n_feat_dim)), _rand(rng, (B, cfg.spk_dim)),
            _rand(rng, (B, cfg.noise_dim)))


@pytest.fixture(scope="module")
def generator_vars():
    jcfg = JV2W(**V2W_SMALL)
    args = tuple(jnp.asarray(a) for a in _generator_inputs(jcfg))
    gen = jv.Generator(jcfg, fused=False)
    return _np(jax.jit(lambda k: gen.init(k, *args, train=False))(jax.random.PRNGKey(7)))


def test_generator_train_mode(generator_vars):
    """``Generator(fused=False)`` in train mode against JAX
    ``Generator.apply(train=True, mutable=["batch_stats", "spectral"])``:
    the waveform, and every running statistic and spectral vector after."""
    jcfg = JV2W(**V2W_SMALL)
    inputs = _generator_inputs(jcfg)
    want, mut = jax.jit(lambda v, *a: jv.Generator(jcfg, fused=False).apply(
        v, *a, train=True, mutable=["batch_stats", "spectral"]))(
        generator_vars, *(jnp.asarray(a) for a in inputs))
    gen = tv.Generator(Vec2WavConfig(**V2W_SMALL), device="cpu", fused=False)
    gen.load_state_dict(weights.generator_state_dict(generator_vars, jcfg), strict=True)
    got = gen.train()(*(_t(a) for a in inputs))
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)
    after = weights.generator_state_dict(dict(generator_vars, **_np(mut)), jcfg)
    sd = gen.state_dict()
    n = 0
    for key, w in after.items():
        if key.startswith("cbns.") and key.endswith(("running_mean", "running_var",
                                                      "weight_u", "weight_v")):
            torch.testing.assert_close(sd[key], w, atol=1e-5, rtol=0, msg=key)
            n += 1
    assert n == 4 * len(jcfg.upsample_rates)


def test_fused_and_trainable_generators_share_weights(generator_vars):
    """One state dict loads into both Generators with ``strict=True``; in
    eval mode on the CPU they compute the same plain unit, so the same
    waveform (atol 1e-6); only the fused one runs under inference mode."""
    jcfg = JV2W(**V2W_SMALL)
    cfg = Vec2WavConfig(**V2W_SMALL)
    sd = weights.generator_state_dict(generator_vars, jcfg)
    fused = tv.Generator(cfg, device="cpu")
    plain = tv.Generator(cfg, device="cpu", fused=False)
    fused.load_state_dict(sd, strict=True)
    plain.load_state_dict(sd, strict=True)
    assert fused.fused and not fused.training and plain.training
    inputs = tuple(_t(a) for a in _generator_inputs(jcfg))
    a = fused(*inputs)
    b = plain.eval()(*inputs)
    assert a.is_inference() and not b.is_inference()
    torch.testing.assert_close(b.detach(), a, atol=1e-6, rtol=0)


def test_fused_unit_refuses_grad():
    """The fused unit has no backward: a grad-requiring input raises on the
    CPU as on the card; under no_grad or inference mode it runs."""
    x, w, b = torch.randn(1, 9, 16), torch.randn(3, 16, 16), torch.randn(16)
    with pytest.raises(RuntimeError, match=r"Generator\(fused=False\)"):
        fused_conv_residual(x.requires_grad_(), w, b)
    with pytest.raises(RuntimeError, match=r"Generator\(fused=False\)"):
        fused_conv_residual(x.detach(), torch.nn.Parameter(w), b)
    with torch.no_grad():
        assert fused_conv_residual(x, torch.nn.Parameter(w), b).shape == x.shape
    gen = tv.Generator(Vec2WavConfig(**V2W_SMALL), device="cpu")
    with pytest.raises(RuntimeError, match=r"Generator\(fused=False\)"):
        gen.resblocks[0](torch.randn(1, 9, gen.cfg.upsample_initial_channel // 2))
    with pytest.raises(ValueError, match="fused=False"):
        GANTrainer(gen.cfg, device="cpu", generator=gen)


# --- losses -----------------------------------------------------------------

def test_losses():
    """feature_loss, discriminator_loss, generator_loss: rtol 1e-6."""
    rng = np.random.default_rng(8)
    shapes = [[(2, 5, 3), (2, 7)], [(2, 4), (2, 6, 2, 3)]]
    fr = [[_rand(rng, s) for s in d] for d in shapes]
    fg = [[_rand(rng, s) for s in d] for d in shapes]
    dr = [_rand(rng, (2, 9)), _rand(rng, (2, 4))]
    dg = [_rand(rng, (2, 9)), _rand(rng, (2, 4))]
    tt = lambda t: [[_t(a) for a in d] for d in t]  # noqa: E731
    pairs = [
        (tv.feature_loss(tt(fr), tt(fg)), jv.feature_loss(fr, fg)),
        (tv.discriminator_loss([_t(a) for a in dr], [_t(a) for a in dg])[0],
         jv.discriminator_loss(dr, dg)[0]),
        (tv.generator_loss([_t(a) for a in dg])[0], jv.generator_loss(dg)[0]),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- entry points -----------------------------------------------------------

def test_gan_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Vec2WavConfig(**V2W_SMALL)
    for build in (lambda: GANTrainer(cfg), lambda: tv.MultiPeriodDiscriminator(cfg),
                  lambda: tv.MultiScaleDiscriminator(),
                  lambda: vec2wav_loop.main(vec2wav_loop.parse_args(["--max_steps", "1"]),
                                            cfg=cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_vec2wav_loop_cpu(monkeypatch, tmp_path):
    """``vec2wav_loop.main`` for 3 steps with the tiny demo config on the
    CPU (its run directory under a temporary one, its scalars to JSONL):
    finite scalars, over two epochs' lr (batch size 5 of 10 items)."""
    monkeypatch.chdir(REPO)
    # the JSONL logger: TensorBoard's import would load TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = dataclasses.replace(load_config(Vec2WavConfig, "data/demo/vec2wav_tiny.json"),
                              batch_size=5, run_path=str(tmp_path))
    history = vec2wav_loop.main(vec2wav_loop.parse_args(["--max_steps", "3", "--device", "cpu"]),
                                cfg=cfg).steps
    assert len(history) == 3
    assert all(set(h) == set(SCALAR_KEYS) and all(np.isfinite(list(h.values())))
               for h in history.values())
