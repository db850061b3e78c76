"""The port's f32 flash training step, the long-bucket config's checks
and the flash Synthesizer, against the JAX package on the CPU: the f32
half of ``test_torch_bf16.py``, whose model, weights, batch and
tolerances it shares (see that file's docstring), in a file of its own so
that the suite's workers can run the two halves at once.

The same model, weights and batch as the bf16 step in f32
(``compute_dtype="float32"``, still flash) make the f32 flash step, held
to the f32 step's tolerances of ``test_torch_train.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_bf16 import (
    CFG,
    CFG_F32,
    F32_FLIP_GRAD_GLOBAL_RTOL,
    F32_FLIP_GRAD_RTOL,
    F32_FLIP_MODULES,
    F32_GRAD_RTOL,
    F32_LOSS_RTOL,
    JCFG_F32,
    LONG_CFG,
    N_BUCKET,
    STEP_LENGTHS,
    _items,
    _jax_step,
    _module,
    _port_step,
)
from wavthruvec_pytorch_tpu_torch.config import (
    Text2VecConfig,
    Vec2WavConfig,
    check_ported,
    load_config,
)
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, make_serving_generator
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch


@pytest.fixture(scope="module")
def f32_step():
    """One f32 + flash training step of each package on the bf16 step's
    weights and batch: ``compute_dtype="float32"``, ``flash_attention=True``
    (the port's plain flash version, JAX's dense branch)."""
    batch = make_padded_batch(_items(STEP_LENGTHS, seed=11), CFG_F32)
    jax_losses, jax_out, jax_grads, start = _jax_step(JCFG_F32, batch, jnp.float32)
    trainer = Text2VecTrainer(CFG_F32, device="cpu")
    trainer.model.load_state_dict(start, strict=True)
    losses, out, grads = _port_step(trainer, batch)
    # the port's dense branch on the same weights, for the gradients' printout
    dense = Text2VecTrainer(dataclasses.replace(CFG_F32, flash_attention=False), device="cpu")
    dense.model.load_state_dict(start, strict=True)
    return dict(jax_losses=jax_losses, jax_out=jax_out, jax_grads=jax_grads, losses=losses,
                out=out, grads=grads, dense_grads=_port_step(dense, batch)[2], trainer=trainer)


def test_f32_flash_step_alignment_and_outputs(f32_step):
    """The f32 model takes the flash branch in both stacks; hard alignment
    and durations equal JAX's exactly, and every output is f32."""
    attn = f32_step["trainer"].model.decoder.layer_stack[0].slf_attn
    assert attn.use_flash and attn.w_qs.compute_dtype is None
    out, jout = f32_step["out"], f32_step["jax_out"]
    np.testing.assert_array_equal(out["attn"].numpy(), jout["attn"])
    np.testing.assert_array_equal(out["duration"].numpy(), jout["duration"])
    for k in ("feat_output", "feat_postnet_output", "duration_predictor_output", "attn_soft"):
        assert out[k].dtype == torch.float32 and str(jout[k].dtype) == "float32", k
        err = np.abs(out[k].detach().numpy() - jout[k]).max()
        print(f"{k}: max |port - JAX| {err:.3g} (max |JAX| {np.abs(jout[k]).max():.3g})")


def test_f32_flash_step_losses(f32_step):
    """The five losses == JAX's: rtol 1e-5, as the f32 step of
    ``test_torch_train.py``."""
    print("losses port", f32_step["losses"], "JAX", f32_step["jax_losses"])
    np.testing.assert_allclose(f32_step["losses"], f32_step["jax_losses"], rtol=F32_LOSS_RTOL)


def test_f32_flash_step_gradients(f32_step):
    """Every gradient == JAX's mapped through the weight bridge.  Outside the
    postnet and ECAPA: the f32 step's rule of ``test_torch_train.py``, atol
    1e-3 times the tensor's largest JAX gradient plus 1e-6.  The postnet's
    (below its BiGRU) and ECAPA's gradients are held as ``chip_smoke.py``
    holds the card's f32 step: ||port - JAX|| / ||JAX|| at most 3e-2 per
    tensor and 5e-3 over all tensors.  At T = 512 the BiGRU's bf16 rounding
    of h flips on f32 sums taken in another order, and the flips move single
    elements there by more than 1e-3 of the largest, whatever attention
    does: the printout gives the worst max |error| / max |g| there of the
    port's flash and dense branches against JAX, and between the two."""
    grads, want, dense = f32_step["grads"], f32_step["jax_grads"], f32_step["dense_grads"]
    assert grads and set(grads) <= set(want)
    worst, worst_norm, sq_err, sq_ref = 0.0, 0.0, 0.0, 0.0
    for name, g in grads.items():
        assert g.dtype == torch.float32, name
        ref = want[name]
        scale = float(ref.abs().max())
        diff = float((g - ref).norm())
        sq_err, sq_ref = sq_err + diff ** 2, sq_ref + float(ref.norm()) ** 2
        if _module(name) in F32_FLIP_MODULES:
            if scale > 1e-5:
                worst_norm = max(worst_norm, diff / float(ref.norm()))
                assert diff <= F32_FLIP_GRAD_RTOL * float(ref.norm()), name
            continue
        if scale > 1e-5:
            worst = max(worst, float((g - ref).abs().max()) / scale)
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=F32_GRAD_RTOL * scale + 1e-6,
                                   err_msg=name)
    total = (sq_err / sq_ref) ** 0.5
    print(f"{len(grads)} gradients: worst max |port - JAX| / max |g| {worst:.3g} outside "
          f"{F32_FLIP_MODULES}, worst ||port - JAX|| / ||JAX|| {worst_norm:.3g} inside; "
          f"{total:.3g} over all")
    inside = [n for n in grads if _module(n) in F32_FLIP_MODULES
              and float(want[n].abs().max()) > 1e-5]

    def worst_max(a, b):
        return max(float((a[n] - b[n]).abs().max() / b[n].abs().max()) for n in inside)

    print(f"inside, worst max |error| / max |g|: flash vs JAX {worst_max(grads, want):.3g}, "
          f"dense vs JAX {worst_max(dense, want):.3g}, flash vs dense {worst_max(grads, dense):.3g}")
    assert total <= F32_FLIP_GRAD_GLOBAL_RTOL


def test_check_ported_admits_long_bucket_config():
    """The JAX package's long-bucket config (bf16, flash) passes
    ``check_ported``; its trainer computes in bf16 and serving in f32;
    a bf16 Vec2Wav config (the bf16 GAN step) builds the f32 Generator for
    serving, as the JAX package's serving path does, and the bf16 serving
    Generator builds (``tests/test_torch_serving_bf16.py``)."""
    cfg = load_config(Text2VecConfig, LONG_CFG)
    assert cfg.compute_dtype == "bfloat16" and cfg.flash_attention
    check_ported(cfg)
    small = dataclasses.replace(CFG, n_feat_dim=16, spk_channel=16)
    trainer = Text2VecTrainer(small, device="cpu")
    attn = trainer.model.decoder.layer_stack[0].slf_attn
    assert attn.use_flash and attn.w_qs.compute_dtype == torch.bfloat16
    assert Text2Vec(small, device="cpu").decoder.layer_stack[0].slf_attn.w_qs.compute_dtype is None
    served = Generator(Vec2WavConfig(compute_dtype="bfloat16"), device="cpu")
    assert next(served.parameters()).dtype == torch.float32
    assert served.conv_pre.compute_dtype is None
    gen, state = make_serving_generator(Vec2WavConfig(), Generator(Vec2WavConfig(), device="cpu")
                                        .state_dict(), "bf16", device="cpu")
    assert next(gen.parameters()).dtype == torch.bfloat16
    assert state["conv_pre.weight_v"].dtype == torch.bfloat16


def test_synthesizer_flash_config_f32():
    """A Synthesizer built from a bf16 + flash config runs Text2Vec in f32
    and its flash branch (text bucket 256, 256 frames): its latents equal
    those of the same weights without flash, atol 1e-5 (f32 sums in
    another order; pad rows are masked in both)."""
    cfg = dataclasses.replace(CFG, n_feat_dim=16, spk_channel=16, text_buckets=(N_BUCKET,),
                              frame_buckets=(256,))
    v2w = Vec2WavConfig(n_feat_dim=16, num_wv_feat=16, spk_dim=4, noise_dim=4,
                        upsample_initial_channel=16, upsample_rates=(2,),
                        upsample_kernel_sizes=(4,), resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 2),))
    torch.manual_seed(0)
    t2v_state = Text2Vec(cfg, device="cpu").state_dict()
    t2v_state["length_regulator.duration_predictor.linear_layer.linear_layer.bias"] += 2.0
    gen_state = Generator(v2w, device="cpu").state_dict()
    frontend = TextFrontend("PE " + "abcdefghijklmnopqrstuvwxyz")
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((1, 20, 16)).astype(np.float32)
    lat = {}
    for flash in (True, False):
        syn = Synthesizer(dataclasses.replace(cfg, flash_attention=flash), v2w, t2v_state,
                          gen_state, frontend, device="cpu")
        assert syn.t2v.encoder.layer_stack[0].slf_attn.w_qs.compute_dtype is None
        lat[flash] = syn.text_to_latents(["hello world"], ref)
    assert lat[True]["total_frames"][0] > 0
    np.testing.assert_array_equal(lat[True]["total_frames"], lat[False]["total_frames"])
    np.testing.assert_allclose(lat[True]["feat_postnet_output"], lat[False]["feat_postnet_output"],
                               atol=1e-5)
