"""``PartialConv1d`` and ConvAttention's partial-padding mode
(``attn_use_partial_padding=True``) against the JAX package on the CPU.

* The layer against JAX ``models/layers.py`` ``PartialConv1d``, with and
  without a mask, kernel sizes 3 and 5 (with a dilation): atol 1e-5, f32
  both sides.  The parameters are Conv1d's, so the same state dict loads.
* One Text2Vec training step with the flag on against JAX's, built as
  ``tests/test_torch_train.py`` builds its step (B = 8, dropout 0, the
  Pallas BiGRU in interpret mode), at that file's tolerances: hard
  alignments and durations exact, losses rtol 1e-5, every gradient within
  1e-3 of the tensor's largest JAX gradient (plus 1e-6 for gradients that
  are 0 but for rounding).  The postnet's gradients reach it through the
  BiGRU, whose bf16 rounding of h flips on f32 sums taken in another order
  (the flips moved a conv bank's largest element by 6% here): they are held
  by norm, ||port - JAX|| / ||JAX|| <= 3e-2 per tensor, as
  ``tests/test_torch_bf16.py`` and ``chip_smoke.py`` hold them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import (
    JCFG,
    STEP_LENGTHS,
    _init_params,
    _items,
    _randomize_stats,
)
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu.models import losses as jlosses
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch

PCFG = dataclasses.replace(JCFG, attn_use_partial_padding=True)
CFG = Text2VecConfig(**{f.name: getattr(PCFG, f.name)
                        for f in dataclasses.fields(Text2VecConfig)})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k,dilation", [(3, 1), (5, 2)])
def test_partial_conv1d_matches_jax(k, dilation, masked):
    rng = np.random.default_rng(k + masked)
    B, T, C_in, C_out = 2, 13, 6, 5
    pad = dilation * (k - 1) // 2
    x = rng.standard_normal((B, T, C_in)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), np.float32)
        mask[0, 9:] = 0.0
        mask[1, :6] = 0.0
        mask[1, 8] = 0.0
    jm = jl.PartialConv1d(C_out, kernel_size=k, padding=pad, dilation=dilation)
    jmask = None if mask is None else jnp.asarray(mask)
    jv = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(k), jnp.asarray(x),
                                                    jmask))
    want = np.asarray(jm.apply(jv, jnp.asarray(x), jmask))
    tm = tl.PartialConv1d(C_in, C_out, k, padding=pad, dilation=dilation, device="cpu")
    conv = jv["params"]["Conv_0"]
    tm.load_state_dict({"weight": torch.tensor(np.transpose(conv["kernel"], (2, 1, 0))),
                        "bias": torch.tensor(conv["bias"])}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if masked:  # a window that covers nothing gives 0, bias included
        taps = np.arange(T)[:, None] - pad + dilation * np.arange(k)[None]
        inside = (taps >= 0) & (taps < T)
        covered = (inside & (mask[1][np.clip(taps, 0, T - 1)] > 0)).any(axis=1)
        assert (~covered).any() and not got[1, ~covered].any()


@pytest.fixture(scope="module")
def partial_step():
    """One training step of each package with ``attn_use_partial_padding``
    on, on the same weights and batch (``tests/test_torch_train.py``'s
    ``step_pair`` with the flag)."""
    batch = make_padded_batch(_items(CFG, STEP_LENGTHS, seed=7), CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos"))
    model = JText2Vec(PCFG)
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key, "dropout": key}, *args, attn_prior=jb["attn_prior"],
        deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 8)
    stats = _randomize_stats(shapes["batch_stats"], 8)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": stats}, *args,
                             attn_prior=jb["attn_prior"], binarize_attention=True,
                             deterministic=False, train_bn=True,
                             rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        w, p, d = jlosses.dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                   jb["feat_target"], out["duration_predictor_output"],
                                   out["duration"])
        b = jlosses.attention_binarization_loss(out["attn"], out["attn_soft"])
        total = w + p + d + PCFG.binarization_loss_weight * b
        return total, ((total, w, p, d, b), out)

    (_, (jloss, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = Text2Vec(CFG, device="cpu")
    port.load_state_dict(weights.text2vec_state_dict({"params": params, "batch_stats": stats},
                                                     PCFG), strict=True)
    assert isinstance(port.attention.query_proj[0].conv, tl.PartialConv1d)
    trainer = Text2VecTrainer(CFG, device="cpu", model=port)
    total, metrics, out = trainer.forward(trainer.to_device(batch))
    trainer.backward(total)
    grads = {n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}
    return dict(jax_losses=[float(v) for v in jloss],
                jax_out=jax.tree_util.tree_map(np.asarray, jout),
                jax_grads=weights.text2vec_state_dict(
                    {"params": jax.tree_util.tree_map(np.asarray, jgrads),
                     "batch_stats": stats}, PCFG),
                losses=[metrics[k].item() for k in metrics], out=out, grads=grads)


def test_partial_padding_step_alignment_and_losses(partial_step):
    s = partial_step
    np.testing.assert_array_equal(s["out"]["attn"].numpy(), s["jax_out"]["attn"])
    np.testing.assert_array_equal(s["out"]["duration"].numpy(), s["jax_out"]["duration"])
    np.testing.assert_allclose(s["out"]["attn_soft"].detach().numpy(), s["jax_out"]["attn_soft"],
                               atol=1e-4)
    print("losses port", s["losses"], "JAX", s["jax_losses"])
    np.testing.assert_allclose(s["losses"], s["jax_losses"], rtol=1e-5)


def test_partial_padding_step_gradients(partial_step):
    grads, want = partial_step["grads"], partial_step["jax_grads"]
    attention = [n for n in grads if n.startswith("attention.")]
    assert len(attention) == 10  # 5 partial convolutions, weight and bias
    worst = 0.0
    for name, g in grads.items():
        ref = want[name].numpy()
        if name.startswith("postnet."):
            err = np.linalg.norm(g.numpy() - ref) / (np.linalg.norm(ref) + 1e-12)
            assert err <= 3e-2 or np.abs(ref).max() <= 1e-5, (name, err)
            worst = max(worst, err)
        else:
            np.testing.assert_allclose(g.numpy(), ref, atol=1e-3 * np.abs(ref).max() + 1e-6,
                                       err_msg=name)
    print(f"postnet gradients: worst ||port - JAX|| / ||JAX|| {worst:.3g}")
