"""The bf16 serving Generator (``make_serving_generator(..., "bf16")``)
against the JAX package's on the CPU.

* The port's ``fold_weight_norm`` on a state dict equals the JAX
  ``fold_weight_norm`` carried through ``weights.py``, to f32 rounding
  (rtol 1e-6: the norms sum in another order).
* The bf16 Generator's waveform against JAX's bf16 ``Generator``, held to
  bf16's own noise, as ``tests/test_torch_bf16.py`` holds the bf16 step:
  ||port - JAX_bf16|| <= 2 ||JAX_bf16 - JAX_f32||.
* No ResBlock2 unit of the bf16 Generator calls ``fused_conv_residual``
  (the JAX gate sends bf16 to XLA's convolution); the f32 one calls it in
  every unit, folded or not.
* Its audio comes out f32 through ``Synthesizer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_serve import make_synth
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.infer.synthesize import make_serving_generator as jax_serving_generator
from wavthruvec_pytorch_tpu.models import Generator as JGenerator
from wavthruvec_pytorch_tpu.models.vec2wav import fold_weight_norm as jax_fold
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, make_serving_generator
from wavthruvec_pytorch_tpu_torch.models import vec2wav
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator, fold_weight_norm

V2W = dict(n_feat_dim=64, num_wv_feat=64, spk_dim=16, noise_dim=16, upsample_initial_channel=64,
           upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
           resblock_dilation_sizes=((1, 3), (1, 3)), periods=(2, 3))
NOISE_RATIO = 2.0


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JV2W(**V2W), Vec2WavConfig(**V2W)
    rng = np.random.default_rng(0)
    B, T = 2, 40
    inputs = (rng.standard_normal((B, T, 64)).astype(np.float32),
              rng.standard_normal((B, 16)).astype(np.float32),
              rng.standard_normal((B, 16)).astype(np.float32))
    jgen = JGenerator(jcfg)
    jvars = jgen.init(jax.random.PRNGKey(3), *map(jnp.asarray, inputs), train=False)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    f32 = np.asarray(jgen.apply(jvars, *inputs, train=False))[..., 0]
    jgen16, jvars16 = jax_serving_generator(jcfg, jvars, "bf16")
    bf16 = np.asarray(jgen16.apply(jvars16, *map(jnp.asarray, inputs), train=False))[..., 0]
    assert bf16.dtype == np.float32
    return cfg, jcfg, jvars, weights.generator_state_dict(jvars, jcfg), inputs, f32, bf16


def _forward(gen, inputs):
    return gen(*(torch.tensor(a) for a in inputs))[..., 0]


def test_fold_matches_jax(setup):
    cfg, jcfg, jvars, state, _, _, _ = setup
    want = weights.generator_state_dict({**jvars, "params": jax_fold(jvars["params"])}, jcfg)
    got = fold_weight_norm(state)
    assert got.keys() == state.keys() == want.keys()
    n_folded = 0
    for key in state:
        torch.testing.assert_close(got[key], want[key], rtol=1e-6, atol=1e-7, msg=key)
        if key.endswith(".weight_g"):
            n_folded += 1
    # conv_pre, conv_post, 2 upsamplers, 2 x 2 resblocks x 2 convs
    assert n_folded == 12
    # spectral norm's vectors have no weight_g beside them and pass as they are
    assert torch.equal(got["cbns.0.layer.weight_v"], state["cbns.0.layer.weight_v"])


def test_bf16_generator_matches_jax_bf16(setup):
    cfg, _, _, state, inputs, f32, jax_bf16 = setup
    gen, gen_state = make_serving_generator(cfg, state, "bf16", device="cpu")
    gen.load_state_dict(gen_state, strict=True)
    assert all(p.dtype == torch.bfloat16 for p in gen.parameters())
    assert all(b.dtype in (torch.bfloat16, torch.long) for b in gen.buffers())
    wav = _forward(gen, inputs)
    assert wav.dtype == torch.float32 and bool(torch.isfinite(wav).all())
    wav = wav.numpy()
    gap = np.linalg.norm(jax_bf16 - f32)
    dist = np.linalg.norm(wav - jax_bf16)
    print(f"bf16 Generator: ||port - JAX_bf16|| / ||JAX_bf16 - JAX_f32|| = {dist / gap:.3g} "
          f"(JAX bf16 lies {gap / np.linalg.norm(f32):.3g} of the norm from f32)")
    assert gap > 0 and dist <= NOISE_RATIO * gap


def _counting(monkeypatch):
    calls = []
    real = vec2wav.fused_conv_residual

    def fused(*args, **kwargs):
        calls.append(args[0].dtype)
        return real(*args, **kwargs)

    monkeypatch.setattr(vec2wav, "fused_conv_residual", fused)
    return calls


def test_bf16_generator_calls_no_fused_unit(setup, monkeypatch):
    cfg, _, _, state, inputs, _, _ = setup
    calls = _counting(monkeypatch)
    units = len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes) * 2
    gen, gen_state = make_serving_generator(cfg, state, "bf16", device="cpu")
    gen.load_state_dict(gen_state)
    _forward(gen, inputs)
    assert calls == []
    assert not vec2wav.fused_supported(torch.bfloat16) and vec2wav.fused_supported(torch.float32)
    for folded in (False, True):
        gen, gen_state = make_serving_generator(
            cfg, fold_weight_norm(state) if folded else state, "f32", folded=folded,
            device="cpu")
        gen.load_state_dict(gen_state)
        _forward(gen, inputs)
    assert calls == [torch.float32] * (2 * units)


def test_folded_f32_generator_equals_unfolded(setup):
    """``--folded`` in f32: the same fold without the cast, atol 1e-6."""
    cfg, _, _, state, inputs, f32, _ = setup
    plain = Generator(cfg, device="cpu")
    plain.load_state_dict(state)
    folded = Generator(cfg, device="cpu", folded=True)
    folded.load_state_dict(fold_weight_norm(state))
    want = _forward(plain, inputs).numpy()
    np.testing.assert_allclose(_forward(folded, inputs).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(want, f32, atol=2e-4)  # the f32 port against JAX f32


def test_make_serving_generator_bf16_gives_f32_audio():
    syn0 = make_synth()
    gen, state = make_serving_generator(syn0.v2w_cfg, syn0.gen.state_dict(), "bf16",
                                        device="cpu")
    syn = Synthesizer(syn0.t2v_cfg, syn0.v2w_cfg, syn0.t2v.state_dict(), state, syn0.frontend,
                      device="cpu", gen=gen)
    emb = np.zeros((2, syn.t2v_cfg.n_speaker_dim), np.float32)
    spk = np.ones((2, syn.v2w_cfg.spk_dim), np.float32)
    wav, n_samples = syn.synthesize(["abc", "gfe abc"], None, spk, alpha=4.0, max_frames=32,
                                    t2v_spk_emb=emb)
    assert wav.dtype == np.float32 and wav.shape == (2, 32 * 16) and np.isfinite(wav).all()
    want, _ = syn0.synthesize(["abc", "gfe abc"], None, spk, alpha=4.0, max_frames=32,
                              t2v_spk_emb=emb)
    rel = np.linalg.norm(wav - want) / np.linalg.norm(want)
    assert (n_samples > 0).all() and 0 < rel < 0.1, rel
    with pytest.raises(ValueError, match="precision"):
        make_serving_generator(syn0.v2w_cfg, syn0.gen.state_dict(), "fp8", device="cpu")


def test_bf16_vec2wav_config_still_refused():
    """``Vec2WavConfig.compute_dtype="bfloat16"`` selects the bf16 GAN step
    only; served, such a config builds the f32 Generator, as the JAX
    package's serving path does: f32 parameters, no compute dtype, the
    fused units, and the same waveform as the f32 config's."""
    cfg = Vec2WavConfig(**V2W, compute_dtype="bfloat16")
    torch.manual_seed(0)
    gen = Generator(cfg, device="cpu")
    torch.manual_seed(0)
    f32 = Generator(Vec2WavConfig(**V2W), device="cpu")
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    assert gen.fused and gen.conv_pre.compute_dtype is None
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((1, 8, cfg.n_feat_dim)), dtype=torch.float32)
    spk = torch.tensor(rng.standard_normal((1, cfg.spk_dim)), dtype=torch.float32)
    z = torch.tensor(rng.standard_normal((1, cfg.noise_dim)), dtype=torch.float32)
    wav = gen(x, spk, z)
    assert wav.dtype == torch.float32 and torch.equal(wav, f32(x, spk, z))


@pytest.mark.cuda
def test_fused_conv_residual_refuses_bf16_on_card():
    """On the card the fused unit takes f32 only: bf16 inputs raise, they do
    not quietly take the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel's dtype check runs on CUDA tensors only")
    from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import fused_conv_residual

    x = torch.randn(1, 64, 32, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(3, 32, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        fused_conv_residual(x, w, torch.zeros(32, device="cuda", dtype=torch.bfloat16))
