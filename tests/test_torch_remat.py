"""``Text2VecConfig.remat`` in the port: each FFT block of the encoder and
the decoder is recomputed in the backward of a training forward (JAX:
``nn.remat(FFTBlock)``, models/text2vec.py:95, 136).

Held two ways on the CPU: against JAX's ``remat=True`` step on
``test_torch_train.py``'s config, weights and batch (losses rtol 1e-5,
gradients atol 1e-3 of each tensor's largest, that file's tolerances), and
bit for bit against the port's own ``remat=False`` step, in f32, with
dropout (the recomputation replays the same mask), and in bf16 through the
flash branch (the ``autograd.Function`` recomputes its output and
log-sum-exp; the casts happen inside the recomputed region).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests._torch_parallel_worker import torch_one_thread  # noqa: F401 (a fixture)
from tests.test_torch_train import (
    CFG,
    JCFG,
    STEP_LENGTHS,
    _init_params,
    _items,
    _randomize_stats,
)
from wavthruvec_pytorch_tpu.models import losses as jlosses
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.models.fft_block import FFTBlock
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch


def _port_step(cfg, start, batch, seed=0):
    """One forward and backward of the port from ``start``: the losses, the
    gradients by name, and how many times the FFT blocks ran forward."""
    torch.manual_seed(seed)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    model = Text2Vec(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(start, strict=True)
    calls = []
    for m in model.modules():
        if isinstance(m, FFTBlock):
            m.register_forward_pre_hook(lambda *_: calls.append(1))
    trainer = Text2VecTrainer(cfg, device="cpu", model=model)
    torch.manual_seed(seed + 1)  # the dropout stream
    total, metrics, _ = trainer.forward(trainer.to_device(batch))
    trainer.backward(total)
    return ([metrics[k] for k in metrics],
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None},
            len(calls))


@pytest.fixture(scope="module")
def setup():
    batch = make_padded_batch(_items(CFG, STEP_LENGTHS, seed=7), CFG)
    args = tuple(batch[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                    "output_lengths", "feat_pos"))
    shapes = jax.eval_shape(lambda key: JText2Vec(JCFG).init(
        {"params": key, "dropout": key}, *args, attn_prior=batch["attn_prior"],
        deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 8)
    stats = _randomize_stats(shapes["batch_stats"], 8)
    start = weights.text2vec_state_dict({"params": params, "batch_stats": stats}, JCFG)
    return batch, args, params, stats, start


N_BLOCKS = CFG.encoder_n_layer + CFG.decoder_n_layer


def test_remat_matches_jax_remat_step(setup):
    """The port's ``remat=True`` step == JAX's ``remat=True`` loss and
    gradients (``value_and_grad``, as ``test_torch_train.py`` builds it):
    losses rtol 1e-5, each gradient atol 1e-3 of its tensor's largest plus
    1e-6; every FFT block ran forward twice (the forward and its
    recomputation)."""
    batch, args, params, stats, start = setup
    jcfg = dataclasses.replace(JCFG, remat=True)
    model = JText2Vec(jcfg)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": stats}, *args,
                             attn_prior=batch["attn_prior"], binarize_attention=True,
                             deterministic=False, train_bn=True,
                             rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        w, p, d = jlosses.dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                   batch["feat_target"], out["duration_predictor_output"],
                                   out["duration"])
        b = jlosses.attention_binarization_loss(out["attn"], out["attn_soft"])
        total = w + p + d + jcfg.binarization_loss_weight * b
        return total, (total, w, p, d, b)

    (_, jl), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = weights.text2vec_state_dict(
        {"params": jax.tree_util.tree_map(np.asarray, jgrads), "batch_stats": stats}, jcfg)
    losses, grads, calls = _port_step(dataclasses.replace(CFG, remat=True), start, batch)
    assert calls == 2 * N_BLOCKS
    np.testing.assert_allclose([v.item() for v in losses], [float(v) for v in jl], rtol=1e-5)
    for name, g in grads.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-3 * np.abs(ref).max() + 1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["f32", "dropout", "bf16_flash"])
def test_remat_bit_equal_to_no_remat(setup, case):
    """``remat=True`` and ``remat=False`` give bit-equal losses and
    gradients on the CPU: f32 as above; with dropout 0.1 (the same seed);
    in bf16 through the flash branch (frame bucket 256, where the gate
    passes).  Only the remat run calls each block's forward twice."""
    batch, _, _, _, start = setup
    cfg = CFG
    if case == "dropout":
        cfg = dataclasses.replace(CFG, dropout=0.1)
    elif case == "bf16_flash":
        cfg = dataclasses.replace(CFG, compute_dtype="bfloat16", flash_attention=True,
                                  frame_buckets=(256,))
        batch = make_padded_batch(_items(cfg, STEP_LENGTHS, seed=7), cfg)
    base = _port_step(cfg, start, batch)
    remat = _port_step(dataclasses.replace(cfg, remat=True), start, batch)
    assert (base[2], remat[2]) == (N_BLOCKS, 2 * N_BLOCKS)
    for a, b in zip(base[0], remat[0]):
        assert torch.equal(a, b)
    assert base[1].keys() == remat[1].keys()
    for name, g in base[1].items():
        assert torch.equal(g, remat[1][name]), name
