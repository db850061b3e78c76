"""The port's streaming vocoder (``infer/streaming.py``) on the CPU: the
stitched chunks equal the full forward of the f32 serving Generator, and
equal the JAX package's ``StreamingVocoder`` on the same weights and noise.

Weights come from the JAX ``Generator``'s init, carried over by
``weights.generator_state_dict``.  Tolerance: atol 2e-5 for stitched
against full (as ``tests/test_streaming.py`` holds JAX's; the windows sum
in the same order as the full forward but for the edges' zero padding), and
2e-5 against JAX's stitched output (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.infer.streaming import StreamingVocoder as JStreamingVocoder
from wavthruvec_pytorch_tpu.infer.streaming import (
    conservative_context_frames as jax_context_frames,
)
from wavthruvec_pytorch_tpu.models import Generator as JGenerator
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.infer.streaming import (
    StreamingVocoder,
    conservative_context_frames,
)
from wavthruvec_pytorch_tpu_torch.infer.synthesize import make_serving_generator

# tests/test_models.py V2W_SMALL
V2W = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=8, noise_dim=8, upsample_initial_channel=32,
           upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3))
ATOL = 2e-5


def _setup(resblock):
    cfg = Vec2WavConfig(**V2W, resblock=resblock)
    jcfg = JV2W(**V2W, resblock=resblock)
    rng = np.random.default_rng(0)
    B, T = 2, 37
    lat = rng.standard_normal((B, T, cfg.n_feat_dim)).astype(np.float32)
    spk = rng.standard_normal((B, cfg.spk_dim)).astype(np.float32)
    noise = rng.standard_normal((B, cfg.noise_dim)).astype(np.float32)
    jgen = JGenerator(jcfg)
    jvars = jgen.init(jax.random.PRNGKey(3), jnp.asarray(lat), jnp.asarray(spk),
                      jnp.asarray(noise), train=False)
    gen, state = make_serving_generator(
        cfg, weights.generator_state_dict(jax.tree_util.tree_map(np.asarray, jvars), jcfg),
        device="cpu")
    gen.load_state_dict(state, strict=True)
    full = gen(torch.tensor(lat), torch.tensor(spk), torch.tensor(noise))[..., 0].numpy()
    return cfg, jcfg, gen, jgen, jvars, (lat, spk, noise), full


@pytest.fixture(scope="module")
def resblock2():
    return _setup(1)  # the int 1 selects ResBlock2, as in the reference


@pytest.fixture(scope="module")
def resblock1():
    return _setup("1")


@pytest.mark.parametrize("chunk", [8, 10, 37, 64])
def test_streaming_equals_full_forward(resblock2, chunk):
    cfg, _, gen, _, _, inputs, full = resblock2
    assert conservative_context_frames(cfg) >= 4
    out = StreamingVocoder(gen, cfg, chunk_frames=chunk).vocode(*inputs)
    assert out.shape == full.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, full, atol=ATOL, err_msg=f"chunk={chunk}")


@pytest.mark.parametrize("chunk", [8, 37])
def test_streaming_equals_full_forward_resblock1(resblock1, resblock2, chunk):
    """ResBlock1 reaches further (convs1 dilations plus three dilation-1
    convs2); the context covers it too."""
    cfg, _, gen, _, _, inputs, full = resblock1
    assert cfg.use_resblock1
    assert conservative_context_frames(cfg) > conservative_context_frames(resblock2[0])
    out = StreamingVocoder(gen, cfg, chunk_frames=chunk).vocode(*inputs)
    np.testing.assert_allclose(out, full, atol=ATOL, err_msg=f"chunk={chunk}")


def test_streaming_chunk_sizes_and_order(resblock2):
    cfg, _, gen, _, _, inputs, full = resblock2
    chunks = list(StreamingVocoder(gen, cfg, chunk_frames=10).stream(*inputs))
    up = cfg.total_upsample
    assert [c.shape for c in chunks] == [(2, 10 * up)] * 3 + [(2, 7 * up)]
    # in order: each chunk is its own slice of the full forward
    for i, c in enumerate(chunks):
        np.testing.assert_allclose(c, full[:, i * 10 * up:i * 10 * up + c.shape[1]], atol=ATOL)


def test_insufficient_context_actually_differs(resblock2):
    """With context 0 the stitched output must not match the full forward
    (else the equality above would hold vacuously)."""
    cfg, _, gen, _, _, inputs, full = resblock2
    out = StreamingVocoder(gen, cfg, chunk_frames=8, context_frames=0).vocode(*inputs)
    assert np.abs(out - full).max() > 1e-3


@pytest.mark.parametrize("setup", ["resblock2", "resblock1"])
def test_streaming_matches_jax(setup, request):
    """The port's stitched audio against the JAX package's, same weights and
    noise, with a device tensor of latents as the serve loop passes it."""
    cfg, jcfg, gen, jgen, jvars, (lat, spk, noise), _ = request.getfixturevalue(setup)
    ours = StreamingVocoder(gen, cfg, chunk_frames=10).vocode(torch.tensor(lat), spk, noise)
    theirs = JStreamingVocoder(jgen, jvars, jcfg, chunk_frames=10).vocode(lat, spk, noise)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=ATOL)
    print(f"{setup}: max |port - JAX| stitched {np.abs(ours - theirs).max():.3g}")


@pytest.mark.parametrize("resblock", [1, "1"])
def test_conservative_context_frames_matches_jax(resblock):
    for rates in ((4, 4), (5, 4, 4, 2, 2)):
        kw = dict(V2W, upsample_rates=rates, upsample_kernel_sizes=tuple(2 * r for r in rates))
        assert (conservative_context_frames(Vec2WavConfig(**kw, resblock=resblock))
                == jax_context_frames(JV2W(**kw, resblock=resblock)))
