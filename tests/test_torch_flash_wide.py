"""The slice of flash attention past head dim 256: one Text2Vec training step
whose FFT blocks have a single head of d_k = 288, against the JAX package on
the CPU.

The model: ``encoder_dim`` = ``decoder_dim`` = 256 with the multi-speaker
condition's 32 speaker dims, so both FFT stacks take d_model 288 and, at one
head, d_k = d_v = 288 (``encoder_dim // head`` alone would say 256); 1 + 1
layers; text and frame buckets of 256, so both stacks pass the flash gate.
The port runs the kernels' plain version (on the card: the wide kernels,
zero-padded to 384), JAX its dense branch (its flash gate asks for a TPU).
f32, dropout 0, the weights carried across by ``weights.py``, B = 8 with
padded items and diagonal priors (MAS has no near-ties).

Tolerances, as the f32 step of ``tests/test_torch_train.py``: losses rtol
1e-5; hard alignment and durations equal; every gradient within 1e-3 of its
tensor's largest value plus 1e-6 (for gradients that are 0 but for
rounding), but ECAPA's and the postnet's, held by norm as
``tests/test_torch_bf16.py`` and ``chip_smoke.py`` hold them: at most 3e-2 of
each tensor's norm and 5e-3 over all.  At these widths single elements there
lie up to 4.3e-3 (ECAPA) and 1.8e-3 (the postnet's conv banks) of their
tensor's largest value from JAX's, and the port's dense branch gives the
very same gradients there as its flash branch: f32 rounding of those
modules (ECAPA's batch-wide BatchNorms, the CBHG below the decoder), not
attention.  So the flash step's gradients are also held to the port's dense
step's, every tensor within 1e-3 of its largest plus 1e-6.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_models import T2V_SMALL
from tests.test_torch_bf16 import _jax_step, _port_step
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, check_ported
from wavthruvec_pytorch_tpu_torch.ops import flash_attention as fa
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch

BUCKET = 256
JCFG = dataclasses.replace(
    T2V_SMALL, encoder_dim=256, decoder_dim=256, n_speaker_dim=32, encoder_head=1,
    decoder_head=1, encoder_n_layer=1, decoder_n_layer=1, dropout=0.0, vocab_size=300,
    max_seq_len=BUCKET, text_buckets=(BUCKET,), frame_buckets=(BUCKET,), grad_clip_every=1,
    learning_rate=0.01, flash_attention=True)
CFG = Text2VecConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(Text2VecConfig)})
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
BY_NORM = ("encoder.speaker_encoder.", "postnet.")
NORM_GRAD_RTOL, NORM_GRAD_GLOBAL_RTOL = 3e-2, 5e-3
# (text, frames) of the batch: 1-1.6 frames a character, the first item
# filling both buckets
LENGTHS = [(256, 256), (200, 250), (130, 200), (170, 230), (240, 252), (150, 240),
           (190, 210), (100, 160)]


def _items(seed):
    rng = np.random.default_rng(seed)
    items = []
    for n, t in LENGTHS:
        prior = np.full((t, n), 1e-4, np.float32)
        prior[np.arange(t), np.arange(t) * n // t] = 1.0
        items.append({"text_enc": rng.integers(1, CFG.vocab_size, n).astype(np.int32),
                      "feat_gt_target": (rng.standard_normal((t, CFG.n_feat_dim))
                                         * 0.5).astype(np.float32),
                      "attn_prior": prior})
    return items


def test_one_head_step_past_256_matches_jax():
    """One f32 training forward and backward of the one-head model (d_k 288,
    the flash branch in both stacks) against JAX's ``train_step`` loss under
    ``value_and_grad`` and against the port's dense branch, at the module
    docstring's tolerances; no kernel launches on the CPU."""
    check_ported(CFG)
    batch = make_padded_batch(_items(seed=16), CFG)
    assert batch["text"].shape == (8, BUCKET) and batch["feat_target"].shape[1] == BUCKET
    jax_losses, jax_out, jax_grads, start = _jax_step(JCFG, batch, jnp.float32)

    trainer = Text2VecTrainer(CFG, device="cpu")
    for stack in (trainer.model.encoder, trainer.model.decoder):
        attn = stack.layer_stack[0].slf_attn
        assert attn.use_flash and attn.n_head == 1 and attn.d_k == attn.d_v == 288
        assert fa.kernels_for(attn.d_k) == fa.KERNELS[3:] and fa.kernel_width(attn.d_k) == 320
    trainer.model.load_state_dict(start, strict=True)
    launches = [k.launches for k in fa.KERNELS]
    losses, out, grads = _port_step(trainer, batch)
    assert [k.launches for k in fa.KERNELS] == launches

    np.testing.assert_array_equal(out["attn"].numpy(), jax_out["attn"])
    np.testing.assert_array_equal(out["duration"].numpy(), jax_out["duration"])
    print("losses port", losses, "JAX", jax_losses)
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL)
    params = dict(trainer.model.named_parameters())
    frozen = {n for n, p in params.items() if not p.requires_grad}
    # the dead pre_highway weight has no JAX counterpart and no gradient
    assert set(grads) == set(jax_grads) & set(params) - frozen - {"postnet.pre_highway.weight"}
    dense = Text2VecTrainer(dataclasses.replace(CFG, flash_attention=False), device="cpu")
    dense.model.load_state_dict(start, strict=True)
    dense_grads = _port_step(dense, batch)[2]
    worst, worst_dense, sq_err, sq_ref = 0.0, 0.0, 0.0, 0.0
    for name, g in grads.items():
        want, ref = jax_grads[name], dense_grads[name]
        scale = float(want.abs().max())
        if float(ref.abs().max()) > 1e-5:
            worst_dense = max(worst_dense, float((g - ref).abs().max() / ref.abs().max()))
        np.testing.assert_allclose(g.numpy(), ref.numpy(),
                                   atol=GRAD_RTOL * float(ref.abs().max()) + 1e-6,
                                   err_msg=f"{name}: flash vs dense")
        if name.startswith(BY_NORM):
            diff, norm = float((g - want).norm()), float(want.norm())
            sq_err, sq_ref = sq_err + diff ** 2, sq_ref + norm ** 2
            if scale > 1e-5:
                assert diff <= NORM_GRAD_RTOL * norm, name
            continue
        if scale > 1e-5:
            worst = max(worst, float((g - want).abs().max()) / scale)
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=GRAD_RTOL * scale + 1e-6,
                                   err_msg=name)
    total = (sq_err / sq_ref) ** 0.5
    print(f"{len(grads)} gradients: flash vs dense worst max |diff| / max |g| {worst_dense:.3g}; "
          f"vs JAX worst {worst:.3g} outside {BY_NORM}, ||port - JAX|| / ||JAX|| {total:.3g} "
          "over those")
    assert total <= NORM_GRAD_GLOBAL_RTOL
    attn_grads = [n for n in grads if "slf_attn.w_qs" in n]
    assert attn_grads and all(float(grads[n].abs().max()) > 0 for n in attn_grads)


@pytest.mark.parametrize("D", [300, 448])
def test_query_splits_sum_to_the_backward(D):
    """What ``wide_dkv_f32_merge`` does: dK and dV are sums over query rows,
    so the plain backward with dout kept on one split's 16-query tiles (and
    zero elsewhere, which zeroes delta and dS there) summed over the splits
    in order equals the unsplit backward, in f32 at the kernels' padded
    width (300 runs at 320), within 1e-6.  Splits as ``split_tiles`` cuts
    T = 128 (8 tiles) three ways: 3, 3 and 2 tiles; B = 2, the second item
    padded from 90 on."""
    rng = np.random.default_rng(D)
    B, H, T, W = 2, 1, 128, fa.kernel_width(D)
    q, k, v, dout = (torch.tensor(rng.standard_normal((B, H, T, W)).astype(np.float32))
                     for _ in range(4))
    seg = torch.ones(B, T, dtype=torch.int32)
    seg[1, 90:] = 0
    scale = 1.0 / math.sqrt(D)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    out, _ = fa.flash_attention_plain(*qkv, seg, scale)
    _, want_k, want_v = torch.autograd.grad(out, qkv, dout, retain_graph=True)
    tiles, nsplit = T // 16, 3
    per = -(-tiles // nsplit)
    got_k, got_v = torch.zeros_like(k), torch.zeros_like(v)
    for s in range(nsplit):
        part = torch.zeros_like(dout)
        rows = slice(16 * per * s, min(T, 16 * per * (s + 1)))
        part[:, :, rows] = dout[:, :, rows]
        _, dk, dv = torch.autograd.grad(out, qkv, part, retain_graph=True)
        got_k, got_v = got_k + dk, got_v + dv
    np.testing.assert_allclose(got_k.numpy(), want_k.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-6)


@pytest.mark.parametrize("D", [300, 448])
def test_key_splits_sum_to_dq(D):
    """What ``wide_dq_f32_merge`` does: dQ = sum over keys of dS K, with dS =
    P (dP - delta) sm_scale and P = exp(S sm_scale - lse) from each query
    row's full lse and delta, so the sums of dS K over the key slices of
    16-key tiles that ``split_tiles`` cuts (T = 128: 8 tiles three ways,
    3, 3 and 2), added in split order, equal the same sum over all keys at
    once within 1e-6 in f32 (only the order of the additions differs), and
    autograd's dQ of ``flash_attention_plain`` within 2e-6: autograd's f32
    dQ itself lies up to 1.3e-6 from the float64 sum at D = 300 (largest
    |dQ| 1.44).  f32 at the kernels' padded width (300 runs at 320); B = 2,
    the second item padded from 90 on."""
    rng = np.random.default_rng(D)
    B, H, T, W = 2, 1, 128, fa.kernel_width(D)
    q, k, v, dout = (torch.tensor(rng.standard_normal((B, H, T, W)).astype(np.float32))
                     for _ in range(4))
    seg = torch.ones(B, T, dtype=torch.int32)
    seg[1, 90:] = 0
    scale = 1.0 / math.sqrt(D)
    qkv = [t.requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_attention_plain(*qkv, seg, scale)
    (want,) = torch.autograd.grad(out, qkv[:1], dout)
    same = seg[:, None, :, None] == seg[:, None, None, :]

    def dq_sum(keys, dtype):
        """dS K over the keys `keys`, in `dtype`."""
        q_, k_, v_, do_, o_, lse_ = (t.detach().to(dtype) for t in (q, k, v, dout, out, lse))
        delta = (do_ * o_).sum(-1, keepdim=True)
        scores = torch.where(same[..., keys], q_ @ k_[:, :, keys].transpose(-1, -2) * scale,
                             fa.MASK_VALUE)
        ds = (torch.exp(scores - lse_[..., None])
              * (do_ @ v_[:, :, keys].transpose(-1, -2) - delta) * scale)
        return ds @ k_[:, :, keys]

    tiles, nsplit = T // 16, 3
    per = -(-tiles // nsplit)
    splits = [slice(16 * per * s, min(T, 16 * per * (s + 1))) for s in range(nsplit)]
    for dtype, tol, ref in ((torch.float32, 1e-6, dq_sum(slice(None), torch.float32)),
                            (torch.float64, 2e-6, want.double())):
        got = torch.zeros(B, H, T, W, dtype=dtype)
        for keys in splits:
            got = got + dq_sum(keys, dtype)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=tol)
