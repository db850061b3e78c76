"""The port's weights.py against the JAX package's exporters: the same keys
and values as ``checkpoint.export_text2vec`` / ``export_vec2wav_generator``,
and state dicts that the port's models load with ``strict=True``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavthruvec_pytorch_tpu import checkpoint as ckpt
from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.infer.synthesize import init_import_models
from wavthruvec_pytorch_tpu.models import Generator as JGenerator
from wavthruvec_pytorch_tpu.models import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator

T2V_SMALL = dict(n_feat_dim=32, spk_channel=32, n_speaker_dim=16, vocab_size=50,
                 max_seq_len=64, encoder_dim=24, encoder_n_layer=2,
                 encoder_conv1d_filter_size=48, decoder_dim=24, decoder_n_layer=2,
                 decoder_conv1d_filter_size=48, duration_predictor_filter_size=16)
V2W_SMALL = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=8, noise_dim=8,
                 upsample_initial_channel=32, upsample_rates=(4, 4),
                 upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3))
V2W_RESBLOCK1 = dict(V2W_SMALL, resblock="1", resblock_dilation_sizes=((1, 2, 3), (1, 2, 3)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(port_sd, ref_sd):
    assert set(port_sd) == set(ref_sd)
    for k, v in ref_sd.items():
        got = port_sd[k].numpy()
        assert got.shape == np.shape(v), k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


@pytest.mark.parametrize("t2v_kw,v2w_kw", [(T2V_SMALL, V2W_SMALL), (T2V_SMALL, V2W_RESBLOCK1)])
def test_small_models_keys_values_and_strict_load(t2v_kw, v2w_kw):
    jt2v_cfg, jv2w_cfg = JT2V(**t2v_kw), JV2W(**v2w_kw)
    _, t2v_vars, _, gen_vars = init_import_models(jt2v_cfg, jv2w_cfg)
    t2v_vars, gen_vars = _np(t2v_vars), _np(gen_vars)

    sd = weights.text2vec_state_dict(t2v_vars, jt2v_cfg)
    _assert_same(sd, ckpt.export_text2vec(t2v_vars, jt2v_cfg))
    Text2Vec(Text2VecConfig(**t2v_kw), device="cpu").load_state_dict(sd, strict=True)

    gsd = weights.generator_state_dict(gen_vars, jv2w_cfg)
    _assert_same(gsd, ckpt.export_vec2wav_generator(gen_vars, jv2w_cfg))
    Generator(Vec2WavConfig(**v2w_kw), device="cpu").load_state_dict(gsd, strict=True)


def _zeros_like_shapes(shapes):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def test_full_size_models_strict_load():
    """Full-size configs: every key and shape of the exporters' state dicts
    matches the port's modules (variables traced with eval_shape, no compute)."""
    jcfg, jvcfg = JT2V(), JV2W()
    t2v = JText2Vec(jcfg)
    t_ref, n = 16, 8
    shapes = jax.eval_shape(lambda: t2v.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.ones((1, n), jnp.int32), jnp.arange(1, n + 1, dtype=jnp.int32)[None],
        jnp.zeros((1, t_ref, jcfg.n_feat_dim)), jnp.array([n]), jnp.array([t_ref]),
        jnp.arange(1, t_ref + 1, dtype=jnp.int32)[None],
        attn_prior=jnp.ones((1, t_ref, n)), deterministic=True, train_bn=False))
    t2v_vars = _zeros_like_shapes(shapes)
    sd = weights.text2vec_state_dict(t2v_vars, jcfg)
    _assert_same(sd, ckpt.export_text2vec(t2v_vars, jcfg))
    Text2Vec(Text2VecConfig(), device="cpu").load_state_dict(sd, strict=True)

    gen = JGenerator(jvcfg)
    gshapes = jax.eval_shape(lambda: gen.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, jvcfg.n_feat_dim)),
        jnp.zeros((1, jvcfg.spk_dim)), jnp.zeros((1, jvcfg.noise_dim)), train=False))
    gen_vars = _zeros_like_shapes(gshapes)
    gsd = weights.generator_state_dict(gen_vars, jvcfg)
    _assert_same(gsd, ckpt.export_vec2wav_generator(gen_vars, jvcfg))
    Generator(Vec2WavConfig(), device="cpu").load_state_dict(gsd, strict=True)


def test_missing_key_fails_strict_load():
    jt2v_cfg, jv2w_cfg = JT2V(**T2V_SMALL), JV2W(**V2W_SMALL)
    _, _, _, gen_vars = init_import_models(jt2v_cfg, jv2w_cfg)
    gsd = weights.generator_state_dict(_np(gen_vars), jv2w_cfg)
    gsd.pop("conv_pre.weight_g")
    with pytest.raises(RuntimeError, match="conv_pre.weight_g"):
        Generator(Vec2WavConfig(**V2W_SMALL), device="cpu").load_state_dict(gsd, strict=True)
