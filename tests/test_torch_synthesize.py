"""The port's main path as a whole, text -> latents -> wav, against the JAX
package on the CPU: the port's ``Synthesizer`` against the JAX
``Synthesizer``, and the port's ``entry()`` against JAX ``Text2Vec.infer``
followed by the JAX ``Generator``.

The config is T2V_SMALL-shaped with ``n_feat_dim = 128`` and
``gru_impl="pallas"``, so the JAX BiGRU takes its Pallas kernel (interpret
mode on the CPU, ``gru_pallas.py`` needs H % 128 == 0) and computes what the
port's BiGRU computes.  The duration predictor's output bias is raised by 3
so that the random model speaks several frames per token.

Tolerances: durations and total_frames exact (inputs keep every
``(dp + 0.5) * alpha`` at least 1e-4 from an integer, asserted); latents
atol 1e-3 (the f32 sums around the bf16 rounding run in another order);
waveforms atol 2e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.infer.synthesize import Synthesizer as JSynthesizer
from wavthruvec_pytorch_tpu.infer.synthesize import init_import_models
from wavthruvec_pytorch_tpu.models import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.text import TextFrontend as JTextFrontend
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.entry import entry
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

T2V = dict(n_feat_dim=128, spk_channel=32, n_speaker_dim=16, vocab_size=50,
           max_seq_len=64, encoder_dim=24, encoder_n_layer=2,
           encoder_conv1d_filter_size=48, decoder_dim=24, decoder_n_layer=2,
           decoder_conv1d_filter_size=48, duration_predictor_filter_size=16,
           gru_impl="pallas", text_buckets=(16, 32), frame_buckets=(48, 96))
V2W = dict(n_feat_dim=128, num_wv_feat=128, spk_dim=8, noise_dim=8,
           upsample_initial_channel=32, upsample_rates=(4, 4),
           upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3))
SYMBOLS = "PE " + "abcdefghijklmnopqrstuvwxyzABCDFGHIJKLMNOQRSTUVW"
DP_BIAS = 3.0
MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jt2v_cfg, jv2w_cfg = JT2V(**T2V), JV2W(**V2W)
    assert len(SYMBOLS) == jt2v_cfg.vocab_size
    _, t2v_vars, _, gen_vars = init_import_models(jt2v_cfg, jv2w_cfg)
    t2v_vars = jax.tree_util.tree_map(np.asarray, t2v_vars)
    gen_vars = jax.tree_util.tree_map(np.asarray, gen_vars)
    lin = t2v_vars["params"]["duration_predictor"]["linear_layer"]["Dense_0"]
    lin["bias"] = lin["bias"] + np.float32(DP_BIAS)
    return (jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars,
            weights.text2vec_state_dict(t2v_vars, jt2v_cfg),
            weights.generator_state_dict(gen_vars, jv2w_cfg))


def _assert_duration_margin(dp, src_seq, alpha):
    v = (np.asarray(dp, np.float64) + 0.5) * alpha
    dist = np.abs(v - np.round(v))[np.asarray(src_seq) != 0]
    assert dist.min() >= MARGIN, dist.min()


def test_synthesizer_matches_jax(models):
    jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, t2v_sd, gen_sd = models
    rng = np.random.default_rng(0)
    texts = ["abcdefg", "hij klmnopq rst"]
    ref = (rng.standard_normal((2, 21, 128)) * 0.5).astype(np.float32)
    spk = rng.standard_normal((2, 8)).astype(np.float32)
    alpha, seed = 1.3, 7

    jsyn = JSynthesizer(jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, JTextFrontend(SYMBOLS))
    syn = Synthesizer(Text2VecConfig(**T2V), Vec2WavConfig(**V2W), t2v_sd, gen_sd,
                      TextFrontend(SYMBOLS), device="cpu")

    # durations: exact, with the rounding margin asserted on the JAX side
    ids, _ = JTextFrontend(SYMBOLS).encode_batch(texts, pad_to=32)  # the Synthesizer's bucket
    pos = np.where(ids != 0, np.arange(1, 33)[None], 0)
    jout = JText2Vec(jt2v_cfg).apply(t2v_vars, jnp.asarray(ids), jnp.asarray(pos),
                                     jnp.asarray(ref), 48, alpha, method=JText2Vec.infer)
    _assert_duration_margin(jout["duration_predictor_output"], ids, alpha)
    tout = syn.t2v.infer(torch.tensor(ids, dtype=torch.int64), torch.tensor(pos),
                         torch.tensor(ref), 48, alpha)
    np.testing.assert_array_equal(tout["durations"].numpy(), np.asarray(jout["durations"]))

    lat = syn.text_to_latents(texts, ref, alpha=alpha)
    jlat = jsyn.text_to_latents(texts, ref, alpha=alpha)
    np.testing.assert_array_equal(lat["total_frames"], jlat["total_frames"])
    assert lat["total_frames"].min() > 0 and lat["finite_ok"].all()
    np.testing.assert_array_equal(lat["input_lengths"], jlat["input_lengths"])
    for key in ("feat_output", "feat_postnet_output"):
        assert lat[key].shape == (2, 96, 128)
        np.testing.assert_allclose(lat[key], jlat[key], atol=1e-3)
        print(f"Synthesizer {key}: max |port - JAX| {np.abs(lat[key] - jlat[key]).max():.3g}")

    jnoise = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (2, 8)))
    wav, n_samples = syn.synthesize(texts, ref, spk, alpha=alpha, seed=seed, noise=jnoise)
    jwav, jn_samples = jsyn.synthesize(texts, ref, spk, alpha=alpha, seed=seed)
    np.testing.assert_array_equal(n_samples, jn_samples)
    assert wav.shape == jwav.shape == (2, 96 * 16)
    np.testing.assert_allclose(wav, jwav, atol=2e-3)
    print(f"Synthesizer wav: max |port - JAX| {np.abs(wav - jwav).max():.3g}")

    # pcm16: clip, scale, truncate toward zero, as the JAX serving path does
    pcm = syn.latents_to_wav(lat["feat_postnet_output"], spk, noise=jnoise, pcm16=True)
    jpcm = jsyn.latents_to_wav(jlat["feat_postnet_output"], spk, seed=seed, pcm16=True)
    assert pcm.dtype == np.int16 and pcm.shape == jpcm.shape
    fwav = syn.latents_to_wav(lat["feat_postnet_output"], spk, noise=jnoise)
    np.testing.assert_array_equal(pcm, (np.clip(fwav, -1, 1) * 32767.0).astype(np.int16))
    assert np.abs(pcm.astype(np.int32) - jpcm.astype(np.int32)).max() <= int(2e-3 * 32767) + 1

    # precomputed speaker embedding path
    emb = syn.speaker_embedding(ref)
    np.testing.assert_allclose(emb, jsyn.speaker_embedding(ref), atol=1e-4)
    lat2 = syn.text_to_latents(texts, alpha=alpha, t2v_spk_emb=emb)
    np.testing.assert_array_equal(lat2["total_frames"], lat["total_frames"])
    np.testing.assert_allclose(lat2["feat_postnet_output"], lat["feat_postnet_output"],
                               atol=1e-5)


def test_entry_matches_jax_infer_and_generator(models):
    jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, t2v_sd, gen_sd = models
    max_frames = 40
    fn, args = entry("cpu", Text2VecConfig(**T2V), Vec2WavConfig(**V2W), batch=2,
                     n_text=14, max_frames=max_frames, ref_t=19, seed=3)
    t2v, gen = args[0], args[1]
    t2v.load_state_dict(t2v_sd, strict=True)
    gen.load_state_dict(gen_sd, strict=True)
    wav, total = fn(*args)
    src_seq, src_pos, ref, spk, noise = (a.numpy() for a in args[2:])

    from wavthruvec_pytorch_tpu.models import Generator as JGenerator

    jout = JText2Vec(jt2v_cfg).apply(
        t2v_vars, jnp.asarray(src_seq), jnp.asarray(src_pos), jnp.asarray(ref),
        max_frames, 1.0, method=JText2Vec.infer)
    _assert_duration_margin(jout["duration_predictor_output"], src_seq, 1.0)
    np.testing.assert_array_equal(total.numpy(), np.asarray(jout["total_frames"]))
    assert total.min() > 0
    tout = t2v.infer(*args[2:5], max_frames, 1.0)
    np.testing.assert_array_equal(tout["durations"].numpy(), np.asarray(jout["durations"]))
    np.testing.assert_allclose(tout["feat_postnet_output"].numpy(),
                               np.asarray(jout["feat_postnet_output"]), atol=1e-3)
    jwav = JGenerator(jv2w_cfg).apply(gen_vars, jout["feat_postnet_output"],
                                      jnp.asarray(spk), jnp.asarray(noise), train=False)
    assert wav.shape == (2, max_frames * 16)
    np.testing.assert_allclose(wav.numpy(), np.asarray(jwav)[..., 0], atol=2e-3)
    print(f"entry(): latents max |port - JAX| "
          f"{np.abs(tout['feat_postnet_output'].numpy() - jout['feat_postnet_output']).max():.3g}, "
          f"wav {np.abs(wav.numpy() - np.asarray(jwav)[..., 0]).max():.3g}")
