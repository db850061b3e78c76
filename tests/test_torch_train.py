"""The port's Text2Vec training slice against the JAX package on the CPU.

The same numpy inputs go through both packages; JAX weights are carried
into the port by ``weights.text2vec_state_dict``, which also maps a JAX
gradient tree and JAX's updated ``batch_stats`` into the port's key layout.
The kernels' plain versions stand in for the CUDA kernels (the tensors lie
on the CPU); the JAX BiGRU takes the Pallas forward in interpret mode
(``gru_impl="pallas"``, which needs H % 128 == 0, hence ``n_feat_dim`` 128).
Dropout is 0: random streams cannot match across frameworks.

Tolerances: f32 on both sides, sums taken in another order.  Hard
alignments and durations are compared exactly.
"""

import dataclasses
import os
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_models import T2V_SMALL
from wavthruvec_pytorch_tpu.data.prior import beta_binomial_prior_distribution as jax_prior
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu.models import losses as jlosses
from wavthruvec_pytorch_tpu.models.conv_attention import ConvAttention as JConvAttention
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.train import text2vec_train as jtrain
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config
from wavthruvec_pytorch_tpu_torch.data.prior import beta_binomial_prior_distribution
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models import losses as tlosses
from wavthruvec_pytorch_tpu_torch.models.conv_attention import ConvAttention
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.ops.gru import GRURecurrence
from wavthruvec_pytorch_tpu_torch.train import text2vec_loop
from wavthruvec_pytorch_tpu_torch.train.lamb import Lamb
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import (
    Text2VecTrainer,
    clip_by_global_norm,
    make_padded_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = dataclasses.replace(T2V_SMALL, n_feat_dim=128, gru_impl="pallas", dropout=0.0,
                           text_buckets=(16,), frame_buckets=(64,), grad_clip_every=1,
                           learning_rate=0.01)
CFG = Text2VecConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(Text2VecConfig)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, requires_grad=False):
    return torch.tensor(np.array(a), requires_grad=requires_grad)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --- BiGRU backward -------------------------------------------------------

def test_gru_backward_matches_jax_custom_vjp():
    """GRURecurrence's gradients == jax.grad through gru_stacked(impl=
    "pallas") at D=2, B=2, T=16, H=128 (forward bit-equal; the backward's
    f32 sums reassociated): atol 2e-5."""
    from wavthruvec_pytorch_tpu.models.layers import gru_stacked

    rng = np.random.default_rng(0)
    D, B, T, C, H = 2, 2, 16, 64, 128
    bound = 1.0 / np.sqrt(H)
    xs = _rand(rng, (D, B, T, C))
    w_ih, w_hh = (rng.uniform(-bound, bound, (D, n, 3 * H)).astype(np.float32) for n in (C, H))
    b_ih, b_hh = (rng.uniform(-bound, bound, (D, 3 * H)).astype(np.float32) for _ in range(2))
    dy = _rand(rng, (D, B, T, H))
    args = (xs, w_ih, w_hh, b_ih, b_hh)

    def jloss(*a):
        return jnp.sum(gru_stacked(*a, "pallas") * dy)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    xs_t, w_ih_t, w_hh_t, b_ih_t, b_hh_t = (_t(a, True) for a in args)
    calls = GRURecurrence.backward_calls
    gi = torch.matmul(xs_t, w_ih_t[:, None]) + b_ih_t[:, None, None]
    (GRURecurrence.apply(gi, w_hh_t, b_hh_t) * _t(dy)).sum().backward()
    assert GRURecurrence.backward_calls == calls + 1
    for name, got, ref in zip(("xs", "w_ih", "w_hh", "b_ih", "b_hh"),
                              (xs_t, w_ih_t, w_hh_t, b_ih_t, b_hh_t), want):
        ref = np.asarray(ref)
        print(f"d{name}: max |port - JAX| {np.abs(got.grad.numpy() - ref).max():.3g} "
              f"(max |g| {np.abs(ref).max():.3g})")
        np.testing.assert_allclose(got.grad.numpy(), ref, atol=2e-5, err_msg=name)


# --- BatchNorm, ConvAttention, losses -------------------------------------

@pytest.mark.parametrize("shape", [(2, 9, 8), (4, 8)])
def test_batch_norm_train_mode(shape):
    """Train-mode BatchNorm == flax nn.BatchNorm(use_running_average=False):
    output, its gradients, and the updated running statistics, atol 1e-5."""
    rng = np.random.default_rng(1)
    x = _rand(rng, shape, 2.0) + 0.5
    cot = _rand(rng, shape)
    jm = jl.BatchNorm(use_running_average=False)
    jv = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv["params"]["BatchNorm_0"] = {"scale": _rand(rng, 8), "bias": _rand(rng, 8)}
    jv["batch_stats"]["BatchNorm_0"] = {"mean": _rand(rng, 8, 0.1),
                                        "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}

    def jloss(params, x):
        y, mut = jm.apply({"params": params, "batch_stats": jv["batch_stats"]}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (want, stats)), (dparams, dx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jv["params"], jnp.asarray(x))
    sd = weights._to_torch(weights._export({c: {"m": t} for c, t in jv.items()},
                                           [("bn", "m", "m")]))
    bn = tl.BatchNorm(8, device="cpu").train()
    bn.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    xt = _t(x, True)
    got = bn(xt)
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dparams["BatchNorm_0"]["scale"]),
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dparams["BatchNorm_0"]["bias"]),
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["BatchNorm_0"]["mean"]),
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["BatchNorm_0"]["var"]),
                               atol=1e-6)


def test_conv_attention():
    """attn_soft and attn_logprob == JAX ConvAttention with a prior and key
    lengths: atol 1e-5 (soft), 1e-4 (log-probabilities of order 10)."""
    rng = np.random.default_rng(2)
    B, T1, T2, C_feat, C_text = 2, 20, 9, 32, 24
    q = _rand(rng, (B, T1, C_feat))
    k = _rand(rng, (B, T2, C_text))
    key_lens = np.array([9, 6], np.int32)
    prior = (rng.random((B, T1, T2)) + 0.05).astype(np.float32)
    jm = JConvAttention(n_feat_channels=C_feat, n_text_channels=C_text)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(key_lens), jnp.asarray(prior))
    jv = _np(jm.init(jax.random.PRNGKey(2), *jargs))
    want_soft, want_logprob = (np.asarray(a) for a in jm.apply(jv, *jargs))
    rows = [r for r in weights._text2vec_spec(JCFG) if r[1].startswith("attention.")]
    sd = weights._to_torch(weights._export({"params": {"attention": jv["params"]}}, rows))
    tm = ConvAttention(C_feat, C_text, device="cpu")
    tm.load_state_dict({k_[len("attention."):]: v for k_, v in sd.items()}, strict=True)
    with torch.no_grad():
        soft, logprob = tm(_t(q), _t(k), _t(key_lens), _t(prior))
    print(f"ConvAttention: soft {np.abs(soft.numpy() - want_soft).max():.3g}, "
          f"logprob {np.abs(logprob.numpy() - want_logprob).max():.3g}")
    np.testing.assert_allclose(soft.numpy(), want_soft, atol=1e-5)
    np.testing.assert_allclose(logprob.numpy(), want_logprob, atol=1e-4)


def test_losses():
    """dnn_loss and attention_binarization_loss == JAX: rtol 1e-6; the soft
    map holds exact zeros under hard ones, which the eps clip keeps finite."""
    rng = np.random.default_rng(3)
    B, T, N, C = 2, 30, 8, 16
    feats = [_rand(rng, (B, T, C)) for _ in range(3)]
    dur_pred = np.abs(_rand(rng, (B, N), 3.0))
    dur = rng.integers(0, 8, (B, N)).astype(np.int32)
    hard = np.zeros((B, T, N), np.float32)
    hard[np.arange(B)[:, None], np.arange(T)[None], rng.integers(0, N, (B, T))] = 1.0
    soft = rng.random((B, T, N)).astype(np.float32)
    soft[0, :3] = 0.0
    want = jlosses.dnn_loss(*(jnp.asarray(a) for a in feats), jnp.asarray(dur_pred),
                            jnp.asarray(dur))
    got = tlosses.dnn_loss(*(_t(a) for a in feats), _t(dur_pred), _t(dur))
    np.testing.assert_allclose([g.item() for g in got], [float(w) for w in want], rtol=1e-6)
    want_b = float(jlosses.attention_binarization_loss(jnp.asarray(hard), jnp.asarray(soft)))
    got_b = tlosses.attention_binarization_loss(_t(hard), _t(soft)).item()
    assert np.isfinite(got_b)
    np.testing.assert_allclose(got_b, want_b, rtol=1e-6)


# --- optimizer and clip ----------------------------------------------------

def test_lamb_three_steps_match_reference_lamb():
    """Lamb == reference_lamb through optax.inject_hyperparams (as
    make_optimizer builds it) over 3 steps with the same gradients: a tensor
    with ||p|| > 10 (the clamp), one whose gradient is all zero (trust ratio
    1 from a zero Adam step only through weight decay), one plain.  rtol
    1e-5: the hyperparameters are f32 arrays in JAX and Python floats here."""
    rng = np.random.default_rng(4)
    jcfg = dataclasses.replace(T2V_SMALL, learning_rate=0.1)  # the config's defaults otherwise
    init = {"big": _rand(rng, (8, 8), 3.0), "still": _rand(rng, (5,)), "plain": _rand(rng, (3, 4))}
    assert np.linalg.norm(init["big"]) > 10
    grads = [{"big": _rand(rng, (8, 8)), "still": np.zeros(5, np.float32),
              "plain": _rand(rng, (3, 4), 0.1)} for _ in range(3)]
    tx = jtrain.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in init.items()}
    opt = Lamb(list(tparams.values()), lr=jcfg.learning_rate, betas=(jcfg.beta1, jcfg.beta2),
               eps=jcfg.epsilon, weight_decay=jcfg.weight_decay)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = _t(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert not np.array_equal(tparams["still"].detach().numpy(), init["still"])


@pytest.mark.parametrize("max_norm", [100.0, 1.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Below the threshold the gradients stay bit for bit; above it they
    are scaled as optax scales them: rtol 1e-6."""
    rng = np.random.default_rng(5)
    gs = [_rand(rng, (6, 7)), _rand(rng, (11,)), _rand(rng, (2, 3, 4))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in gs],
                                                         optax.EmptyState())
    got = [_t(g) for g in gs]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((g * g).sum() for g in gs)), rtol=1e-6)
    for g, w, orig in zip(got, want, gs):
        if max_norm == 100.0:
            np.testing.assert_array_equal(g.numpy(), orig)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# --- the whole step --------------------------------------------------------

def _items(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [{"text_enc": rng.integers(1, cfg.vocab_size, n).astype(np.int32),
             "feat_gt_target": _rand(rng, (t, cfg.n_feat_dim), 0.5),
             "attn_prior": beta_binomial_prior_distribution(n, t, 1.0).astype(np.float32)}
            for n, t in lengths]


def test_padded_batch_and_prior_match_jax():
    """The port's make_padded_batch and beta-binomial prior == the JAX
    package's, exactly."""
    items = _items(CFG, [(12, 64), (9, 47), (3, 5)], seed=6)
    want = jtrain.make_padded_batch(items, JCFG)
    got = make_padded_batch(items, CFG)
    assert set(got) == set(want) - {"audiopaths"}
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(beta_binomial_prior_distribution(9, 47, 1.0),
                                  jax_prior(9, 47, 1.0))


def _init_params(shapes, seed):
    """Seeded weights for a JAX parameter tree of ``ShapeDtypeStruct``s
    (tracing ``init`` instead of compiling it): kernels N(0, 1/fan_in),
    norm scales 1, biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            return np.ones(v.shape, np.float32)
        if name == "bias" or name.endswith("_b_ih") or name.endswith("_b_hh"):
            return _rand(rng, v.shape, 0.05)
        fan_in = int(np.prod(v.shape[:-1])) if len(v.shape) > 1 else 1
        return _rand(rng, v.shape, 1.0 / np.sqrt(fan_in))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _randomize_stats(stats, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        if str(getattr(path[-1], "key", path[-1])) == "mean":
            return _rand(rng, v.shape, 0.1)
        return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, stats)


# (text, frames) of the step's batch.  B = 8, not 2: at B = 2 ECAPA's last
# BatchNorms normalise over two items, and the random-weight model's
# gradient is then not set by its inputs but by f32 rounding (the port
# alone, run with 1 and with 8 CPU threads, moves by whole tensors).
STEP_LENGTHS = [(12, 64), (9, 60), (5, 57), (7, 50), (16, 64), (10, 62), (8, 40), (11, 58)]


@pytest.fixture(scope="module")
def step_pair():
    """One training step of each package on the same weights and batch
    (B = 8, one text bucket of 16, one frame bucket of 64, grad_clip_every
    = 1 so the clip runs).  The JAX side is ``train_step``'s body
    (text2vec_train.py:140-203) with the gradients kept: the loss under
    ``value_and_grad``, then ``optax.clip_by_global_norm`` and the
    optimizer of ``make_optimizer``."""
    batch = make_padded_batch(_items(CFG, STEP_LENGTHS, seed=7), CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos"))
    model = JText2Vec(JCFG)
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key, "dropout": key}, *args, attn_prior=jb["attn_prior"],
        deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 8)
    stats = _randomize_stats(shapes["batch_stats"], 8)

    def loss_fn(params):
        out, mut = model.apply({"params": params, "batch_stats": stats}, *args,
                               attn_prior=jb["attn_prior"], binarize_attention=True,
                               deterministic=False, train_bn=True,
                               rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        w, p, d = jlosses.dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                   jb["feat_target"], out["duration_predictor_output"],
                                   out["duration"])
        b = jlosses.attention_binarization_loss(out["attn"], out["attn_soft"])
        total = w + p + d + JCFG.binarization_loss_weight * b
        return total, ((total, w, p, d, b), out, mut["batch_stats"])

    (_, (jlosses_, jout, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    clipped, _ = optax.clip_by_global_norm(JCFG.grad_clip_thresh).update(jgrads,
                                                                         optax.EmptyState())
    tx = jtrain.make_optimizer(JCFG)
    updates, _ = tx.update(clipped, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)

    start = weights.text2vec_state_dict({"params": params, "batch_stats": stats}, JCFG)
    port = Text2Vec(CFG, device="cpu")
    port.load_state_dict(start, strict=True)
    trainer = Text2VecTrainer(CFG, device="cpu", model=port)
    total, metrics, out = trainer.forward(trainer.to_device(batch))
    trainer.backward(total)
    grads = {n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}
    trainer.apply_gradients()
    return dict(
        jax_losses=[float(v) for v in jlosses_], jax_out=_np(jout),
        jax_grads=weights.text2vec_state_dict({"params": _np(jgrads), "batch_stats": stats}, JCFG),
        jax_stats=weights.text2vec_state_dict({"params": params, "batch_stats": _np(jstats)}, JCFG),
        jax_new=weights.text2vec_state_dict({"params": _np(jnew), "batch_stats": stats}, JCFG),
        start=start,
        losses=[metrics[k].item() for k in metrics], out=out, grads=grads, port=port,
        trainer=trainer)


def test_step_alignment_exact(step_pair):
    """Hard alignment and durations equal JAX's exactly; soft alignment and
    the outputs before the postnet within atol 1e-4; the postnet output
    within 1e-3, since a 1-ulp f32 difference in the BiGRU's input can flip
    the bf16 rounding of h (as on the card, ``chip_smoke.py``'s GRU_ATOL)."""
    s = step_pair
    out, jout = s["out"], s["jax_out"]
    np.testing.assert_array_equal(out["attn"].numpy(), jout["attn"])
    np.testing.assert_array_equal(out["duration"].numpy(), jout["duration"])
    assert out["duration"].dtype == torch.int32
    for k in ("attn_soft", "attn_logprob", "feat_output", "feat_postnet_output",
              "duration_predictor_output"):
        err = np.abs(out[k].detach().numpy() - jout[k]).max()
        print(f"{k}: max |port - JAX| {err:.3g}")
        atol = 1e-3 if k == "feat_postnet_output" else 1e-4
        np.testing.assert_allclose(out[k].detach().numpy(), jout[k], atol=atol, err_msg=k)


def test_step_losses(step_pair):
    """The five losses == JAX's: rtol 1e-5."""
    print("losses port", step_pair["losses"], "JAX", step_pair["jax_losses"])
    np.testing.assert_allclose(step_pair["losses"], step_pair["jax_losses"], rtol=1e-5)


def test_step_gradients(step_pair):
    """Every gradient == JAX's mapped through the weight bridge: atol 1e-3
    times the tensor's largest JAX gradient, plus 1e-6 for the gradients
    that are 0 but for rounding (biases in front of a softmax or a
    BatchNorm)."""
    grads, want = step_pair["grads"], step_pair["jax_grads"]
    frozen = {n for n, p in step_pair["port"].named_parameters() if not p.requires_grad}
    # the dead pre_highway weight has no JAX counterpart and no gradient
    assert set(grads) == set(want) & {n for n, _ in step_pair["port"].named_parameters()} \
        - frozen - {"postnet.pre_highway.weight"}
    worst = 0.0
    for name, g in grads.items():
        ref = want[name].numpy()
        scale = np.abs(ref).max()
        err = np.abs(g.numpy() - ref).max()
        if scale > 1e-5:
            worst = max(worst, err / scale)
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-3 * scale + 1e-6, err_msg=name)
    print(f"{len(grads)} gradients, worst max |port - JAX| / max |g| {worst:.3g} "
          "(tensors with max |g| > 1e-5)")


def test_step_running_stats_and_update(step_pair):
    """BatchNorm running statistics after the step == JAX's mutated
    batch_stats (atol 1e-5).  Parameters after clip + LAMB == JAX's within
    atol 1e-5 in at least 99.9% of all elements.  The first Adam
    step m / sqrt(v) is +-0.71 whatever |g|, so each element moves by the
    sign of its gradient (less where |g| is near eps), and an element whose
    gradient is 0 but for rounding may move another way: the rest must
    differ by no more than twice the tensor's largest step.  Left out: the
    tensors whose gradient is 0 but for rounding (max |g| <= 1e-5), since
    LAMB scales each tensor's step to lr * ||p|| whatever |g|, and rounding
    noise then sets its direction."""
    port, want_stats, want_new = step_pair["port"], step_pair["jax_stats"], step_pair["jax_new"]
    buffers = dict(port.named_buffers())
    n = 0
    for name, v in want_stats.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(), v.numpy(), atol=1e-5, err_msg=name)
            n += 1
    assert n > 0
    n_off = n_all = 0
    for name, p in port.named_parameters():
        if name in step_pair["grads"] and np.abs(step_pair["jax_grads"][name].numpy()).max() > 1e-5:
            want = want_new[name].numpy()
            diff = np.abs(p.detach().numpy() - want)
            step = np.abs(want - step_pair["start"][name].numpy())
            off = diff > 1e-5
            assert (diff[off] <= 2 * step.max() + 1e-5).all(), name
            n_off, n_all = n_off + int(off.sum()), n_all + diff.size
    assert n_off <= 1e-3 * n_all
    assert step_pair["trainer"].step_count == 1
    print(f"{n} running statistics; parameters after LAMB: {n_off} of {n_all} elements "
          "beyond 1e-5 of JAX's")


# --- the loop ---------------------------------------------------------------

def test_loop_runs_on_tiny_demo(monkeypatch, tmp_path):
    """text2vec_loop.main on data/demo/text2vec_tiny.json, 2 steps on the
    CPU (its run directory under a temporary one, its scalars to JSONL):
    finite losses."""
    monkeypatch.chdir(REPO)  # the config's paths are relative to the repository root
    # the JSONL logger: TensorBoard's import would load TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = dataclasses.replace(load_config(Text2VecConfig, "data/demo/text2vec_tiny.json"),
                              run_path=str(tmp_path))
    history = text2vec_loop.main(text2vec_loop.parse_args(["--max_steps", "2", "--device", "cpu"]),
                                 cfg=cfg).steps
    assert len(history) == 2
    assert all(np.isfinite(list(h.values())).all() for h in history.values())
