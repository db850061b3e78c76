"""The PyTorch port's models against the JAX package's on the CPU: the same
numpy inputs, JAX weights carried over by the port's weights.py, eval mode.

JAX's Generator runs with ``fused=False`` here.  Its Pallas fused unit cannot
run on a CPU (interpret mode cannot discharge the halo DMA,
tests/test_ops.py:290-292), and ``fused_supported`` has no platform check,
so ``fused=True`` on a CPU would reach the compiled Pallas path at
C = 256 and 128.  ``fused=False`` computes the same unit through
``conv_residual_reference``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.models.cbhg import CBHG as JCBHG
from wavthruvec_pytorch_tpu.models.duration import DurationPredictor as JDP
from wavthruvec_pytorch_tpu.models.ecapa import ECAPA_TDNN as JECAPA
from wavthruvec_pytorch_tpu.models.fft_block import FFTBlock as JFFT
from wavthruvec_pytorch_tpu.models.vec2wav import Generator as JGenerator
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.models.cbhg import CBHG
from wavthruvec_pytorch_tpu_torch.models.duration import DurationPredictor
from wavthruvec_pytorch_tpu_torch.models.ecapa import ECAPA_TDNN
from wavthruvec_pytorch_tpu_torch.models.fft_block import FFTBlock
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator

V2W_SMALL = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=8, noise_dim=8,
                 upsample_initial_channel=32, upsample_rates=(4, 4),
                 upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3))


def _randomize_stats(np_vars, seed):
    """Non-trivial BatchNorm running statistics (init leaves mean 0, var 1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    out = dict(np_vars)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(leaf, np_vars["batch_stats"])
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _strip_load(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    return module


def test_fft_block():
    """FFTBlock with a padded batch: atol 2e-5."""
    rng = np.random.default_rng(0)
    B, T, D = 2, 11, 32
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    seq = np.ones((B, T), np.int32)
    seq[1, 7:] = 0
    non_pad = (seq != 0).astype(np.float32)[..., None]
    mask = np.broadcast_to((seq == 0)[:, None, :], (B, T, T))
    jm = JFFT(D, 48, 2, 16, 16)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(non_pad), jnp.asarray(mask))
    want = np.asarray(jm.apply(jv, jnp.asarray(x), jnp.asarray(non_pad), jnp.asarray(mask))[0])
    sd = weights._to_torch(weights._export({"params": {"m": {"layer_stack_0": _np(jv["params"])}}},
                                           weights._fft_stack_spec("m", "m", 1)))
    tm = _strip_load(FFTBlock(D, 48, 2, 16, 16, device="cpu").eval(), sd, "m.layer_stack.0.")
    with torch.no_grad():
        got = tm(torch.tensor(x), torch.tensor(non_pad), torch.tensor(mask))[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_ecapa_feature_input():
    """ECAPA-TDNN on wav2vec-style features, eval mode: atol 1e-4."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 23, 32)).astype(np.float32)
    jm = JECAPA(C=64, n_feat_dim=32, n_speaker_dim=16)
    jv = _randomize_stats(_np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))), 1)
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    sd = weights._to_torch(weights._export({c: {"m": t} for c, t in jv.items()},
                                           weights._ecapa_spec("m", "m")))
    tm = _strip_load(ECAPA_TDNN(64, 32, 16, device="cpu").eval(), sd, "m.")
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_duration_predictor():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 40)).astype(np.float32)
    jm = JDP(16, 3)
    jv = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    rows = [row for row in weights._text2vec_spec(JT2V()) if "duration_predictor" in row[1]]
    sd = weights._to_torch(weights._export({"params": {"duration_predictor": _np(jv["params"])}},
                                           rows))
    tm = _strip_load(DurationPredictor(40, 16, 3, device="cpu").eval(), sd,
                     "length_regulator.duration_predictor.")
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cbhg_with_pallas_gru():
    """CBHG against JAX CBHG(gru_impl="pallas") in interpret mode, the
    port's CBHG built with the same impl: the same bf16 rounding in the
    BiGRU on both sides; atol 1e-4."""
    rng = np.random.default_rng(3)
    H = 128
    x = (rng.standard_normal((2, 21, H)) * 0.5).astype(np.float32)
    jm = JCBHG(H, K=8, projections=(256, H), gru_impl="pallas")
    jv = _randomize_stats(_np(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))), 3)
    want = np.asarray(jm.apply(jv, jnp.asarray(x)))
    rows = [row for row in weights._text2vec_spec(JT2V()) if row[1].startswith("postnet.")]
    sd = weights._to_torch(weights._export({c: {"postnet": t} for c, t in jv.items()}, rows))
    sd["postnet.pre_highway.weight"] = torch.zeros(H, 1024)
    tm = _strip_load(CBHG(H, K=8, gru_impl="pallas", device="cpu").eval(), sd, "postnet.")
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _generator_parity(cfg_kwargs, T, seed, post_gain=1.0):
    jcfg = JV2W(**cfg_kwargs)
    rng = np.random.default_rng(seed)
    B = 2
    x = rng.standard_normal((B, T, jcfg.n_feat_dim)).astype(np.float32)
    spk = rng.standard_normal((B, jcfg.spk_dim)).astype(np.float32)
    noise = rng.standard_normal((B, jcfg.noise_dim)).astype(np.float32)
    jgen = JGenerator(jcfg, fused=False)
    args = tuple(jnp.asarray(a) for a in (x, spk, noise))
    jv = _randomize_stats(_np(jax.jit(lambda k: jgen.init(k, *args, train=False))(
        jax.random.PRNGKey(seed))), seed)
    jv["params"]["conv_post"]["g"] = jv["params"]["conv_post"]["g"] * np.float32(post_gain)
    want = np.asarray(jax.jit(lambda v: jgen.apply(v, *args, train=False))(jv))
    tcfg = Vec2WavConfig(**cfg_kwargs)
    tgen = Generator(tcfg, device="cpu")
    tgen.load_state_dict(weights.generator_state_dict(jv, jcfg), strict=True)
    got = tgen(*(torch.tensor(a) for a in (x, spk, noise))).numpy()
    assert got.shape == (B, T * jcfg.total_upsample, 1)
    print(f"Generator resblock={jcfg.resblock!r} channels={jcfg.upsample_initial_channel}: "
          f"max |port - JAX| {np.abs(got - want).max():.3g}")
    return got, want


@pytest.mark.parametrize("variant", ["resblock2", "resblock1"])
def test_generator_small(variant):
    """Generator on V2W_SMALL: atol 2e-4 (the JAX package's torch-parity
    tolerance for the Generator)."""
    kw = dict(V2W_SMALL)
    if variant == "resblock1":
        kw.update(resblock="1", resblock_dilation_sizes=((1, 2, 3), (1, 2, 3)))
    got, want = _generator_parity(kw, T=11, seed=4)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_generator_full_width():
    """Generator at the full-size config (512 channels, x320, all 30 fused
    units) on 4 latent frames: atol 2e-4.

    conv_post's gain is scaled by 1e-4.  At random init the full-width
    network's waveform is otherwise almost all saturated by the final tanh
    (99.8% of samples above 0.999), and the few samples at its zero crossings
    then magnify f32 rounding of pre-tanh values in the thousands.  Scaled,
    the waveform stays in the tanh's linear range (mean |y| ~ 0.1)."""
    got, want = _generator_parity({}, T=4, seed=5, post_gain=1e-4)
    assert np.abs(want).max() < 0.999
    np.testing.assert_allclose(got, want, atol=2e-4)
