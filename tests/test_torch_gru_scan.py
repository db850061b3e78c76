"""The port's BiGRU at the JAX package's default numerics (``gru_impl="scan"``:
``h`` and ``w_hh`` in f32) and its dispatch between the two numerics, against
the JAX package on the CPU.

The same seeded numpy inputs go through both packages.  JAX's
``_gru_fwd_core`` (models/layers.py:756-787) takes its Pallas kernel (bf16
``h`` and ``w_hh``) only for ``impl="pallas"`` where ``gru_pallas_supported``
admits the shape, and its f32 ``lax.scan`` everywhere else; the port's
``ops.gru.gru_numerics`` makes the same choice, and on the CPU the port runs
the plain version of the kernel it picks.  The configs leave ``gru_impl``
unset (so ``"scan"``) unless a test says otherwise.

Tolerances: f32 on both sides with sums in another order: the recurrence
atol 1e-5; gradients and whole-model outputs as stated in each test.  The
bf16 training step is held to bf16's own noise, as ``test_torch_bf16.py``
holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_models import T2V_SMALL
from tests.test_torch_train import _init_params, _np, _randomize_stats
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu.models import losses as jlosses
from wavthruvec_pytorch_tpu.models.cbhg import CBHG as JCBHG
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.ops.gru_pallas import gru_pallas_supported as jax_gate
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models.cbhg import CBHG
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.ops import gru
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch

GRU_ATOL = 1e-5  # f32 recurrence, sums over H terms in another order
H100_SMS, H100_SMEM = 132, 232448

JCFG = dataclasses.replace(T2V_SMALL, dropout=0.0, text_buckets=(16,), frame_buckets=(64,),
                           grad_clip_every=1, learning_rate=0.01)
CFG = Text2VecConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(Text2VecConfig)})


def _t(a, requires_grad=False):
    return torch.tensor(np.array(a), requires_grad=requires_grad)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _stacked(D, B, T, C, H, seed):
    """xs [D, B, T, C] and torch-initialised stacked weights, numpy."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    xs = _rand(rng, (D, B, T, C), 0.5)
    w_ih, w_hh = (rng.uniform(-bound, bound, (D, n, 3 * H)).astype(np.float32) for n in (C, H))
    b_ih, b_hh = (rng.uniform(-bound, bound, (D, 3 * H)).astype(np.float32) for _ in range(2))
    return xs, w_ih, w_hh, b_ih, b_hh


def _bigru_state(p):
    """JAX BiGRU params -> the port's nn.GRU-named state dict."""
    sd = {}
    for d_, t_ in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"weight_ih_l0{t_}"] = _t(np.asarray(p[f"{d_}_w_ih"]).T)
        sd[f"weight_hh_l0{t_}"] = _t(np.asarray(p[f"{d_}_w_hh"]).T)
        sd[f"bias_ih_l0{t_}"] = _t(p[f"{d_}_b_ih"])
        sd[f"bias_hh_l0{t_}"] = _t(p[f"{d_}_b_hh"])
    return sd


# --- (a) the plain f32 recurrence -------------------------------------------

@pytest.mark.parametrize("D, B, T, C, H", [(2, 2, 17, 24, 48), (1, 3, 9, 16, 32),
                                           (2, 1, 40, 32, 128)])
def test_plain_f32_matches_jax_scan(D, B, T, C, H):
    """gru_fwd_plain(..., "f32") and gru_fwd_f32 on CPU tensors == JAX
    gru_stacked(..., "scan"): atol 1e-5."""
    args = _stacked(D, B, T, C, H, seed=B * 100 + T)
    want = np.asarray(jl.gru_stacked(*(jnp.asarray(a) for a in args), "scan"))
    xs, w_ih, w_hh, b_ih, b_hh = (_t(a) for a in args)
    gi = (torch.matmul(xs, w_ih[:, None]) + b_ih[:, None, None]).contiguous()
    got = gru.gru_fwd_plain(gi, w_hh, b_hh, "f32")
    before = gru.gru_fwd_f32.launches
    torch.testing.assert_close(gru.gru_fwd_f32(gi, w_hh, b_hh), got, rtol=0, atol=0)
    assert gru.gru_fwd_f32.launches == before  # the CPU path launches nothing
    err = np.abs(got.numpy() - want).max()
    print(f"D={D} B={B} T={T} H={H}: max |port - JAX scan| {err:.3g}")
    np.testing.assert_allclose(got.numpy(), want, atol=GRU_ATOL)
    # the bf16 numerics are another function: they miss the scan by far more
    assert np.abs(gru.gru_fwd_plain(gi, w_hh, b_hh).numpy() - want).max() > 10 * GRU_ATOL


# --- (b) the gate and the choice of numerics --------------------------------

@pytest.mark.parametrize("H", [64, 96, 128, 256, 1000, 1024, 2048])
def test_gate_matches_jax(H):
    """The port's copy of gru_pallas_supported == JAX's over a grid of
    (D, B), and gru_numerics picks bf16 for "pallas" exactly where it holds,
    f32 for "scan" and for any other string."""
    for D in (1, 2, 4):
        for B in (1, 2, 8, 16, 28, 29, 32, 64, 512, 4096):
            want = jax_gate(D, B, H)
            assert gru.gru_pallas_supported(D, B, H) == want, (D, B, H)
            assert gru.gru_numerics("pallas", D, B, H) == ("bf16" if want else "f32")
            for impl in ("scan", "Pallas", "cudnn", ""):
                assert gru.gru_numerics(impl, D, B, H) == "f32"


def test_gate_edge_at_cbhg_width():
    """At the CBHG's D = 2, H = 1024 JAX's 14 MiB budget admits B <= 28."""
    assert jax_gate(2, 28, 1024) and not jax_gate(2, 29, 1024)
    assert gru.gru_numerics("pallas", 2, 28, 1024) == "bf16"
    assert gru.gru_numerics("pallas", 2, 29, 1024) == "f32"
    assert gru.gru_numerics("pallas", 2, 1, 1000) == "f32"  # H % 128 != 0


# --- (c) gradients -----------------------------------------------------------

def test_recurrence_gradients_match_jax_scan():
    """GRURecurrence at the f32 numerics: gradients == jax.grad through
    gru_stacked(impl="scan") at D=2, B=2, T=16, H=48 (forward f32 on both
    sides; the backward is JAX's custom VJP, its f32 sums reassociated):
    atol 2e-5, as the bf16 numerics' test in test_torch_train.py."""
    args = _stacked(2, 2, 16, 24, 48, seed=5)
    dy = _rand(np.random.default_rng(6), (2, 2, 16, 48))

    def jloss(*a):
        return jnp.sum(jl.gru_stacked(*a, "scan") * dy)

    want = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in args))
    xs_t, w_ih_t, w_hh_t, b_ih_t, b_hh_t = (_t(a, True) for a in args)
    calls = gru.GRURecurrence.backward_calls
    gi = torch.matmul(xs_t, w_ih_t[:, None]) + b_ih_t[:, None, None]
    (gru.GRURecurrence.apply(gi, w_hh_t, b_hh_t, "f32") * _t(dy)).sum().backward()
    assert gru.GRURecurrence.backward_calls == calls + 1
    for name, got, ref in zip(("xs", "w_ih", "w_hh", "b_ih", "b_hh"),
                              (xs_t, w_ih_t, w_hh_t, b_ih_t, b_hh_t), want):
        ref = np.asarray(ref)
        print(f"d{name}: max |port - JAX| {np.abs(got.grad.numpy() - ref).max():.3g} "
              f"(max |g| {np.abs(ref).max():.3g})")
        np.testing.assert_allclose(got.grad.numpy(), ref, atol=2e-5, err_msg=name)


def test_recurrence_refuses_unknown_precision():
    gi, w, b = torch.zeros(1, 1, 2, 24), torch.zeros(1, 8, 24), torch.zeros(1, 24)
    for fn in (lambda: gru.GRURecurrence.apply(gi, w, b, "fp16"),
               lambda: gru.gru_fwd_plain(gi, w, b, "tf32"),
               lambda: gru.gru_fwd_plan(1, 1, 8, H100_SMS, H100_SMEM, "fp8")):
        with pytest.raises(ValueError, match="precision"):
            fn()


# --- (d) BiGRU, CBHG, Text2Vec.infer at the default impl --------------------

def test_bigru_default_is_scan():
    """The port's BiGRU with gru_impl unset == JAX BiGRU() (impl "scan"):
    atol 1e-5, at B = 1 and 3."""
    for B, seed in ((1, 0), (3, 1)):
        x = _rand(np.random.default_rng(seed), (B, 23, 20), 0.5)
        jm = jl.BiGRU(hidden=40)
        v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
        tm = tl.BiGRU(20, 40, device="cpu")
        assert tm.gru_impl == "scan" and tm.numerics(B) == "f32"
        tm.load_state_dict(_bigru_state(v["params"]), strict=True)
        with torch.no_grad():
            got = tm(_t(x)).numpy()
        np.testing.assert_allclose(got, want, atol=GRU_ATOL)


def _cbhg_pair(H, gru_impl, x, seed):
    """JAX CBHG(gru_impl) and the port's CBHG(gru_impl) on the same seeded
    weights and randomized BatchNorm statistics, both in eval mode."""
    jm = JCBHG(H, K=8, projections=(256, H), gru_impl=gru_impl)
    jv = _randomize_stats(_np(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))), seed)
    rows = [row for row in weights._text2vec_spec(JCFG) if row[1].startswith("postnet.")]
    sd = weights._to_torch(weights._export({c: {"postnet": t} for c, t in jv.items()}, rows))
    sd["postnet.pre_highway.weight"] = torch.zeros(H, 1024)
    tm = CBHG(H, K=8, gru_impl=gru_impl, device="cpu").eval()
    tm.load_state_dict({k[len("postnet."):]: v for k, v in sd.items()}, strict=True)
    return jm, jv, tm


def test_cbhg_default_is_scan():
    """The port's CBHG with gru_impl unset == JAX CBHG() (its default
    "scan"): convolutions, BatchNorms and highways in f32 before the f32
    BiGRU, atol 2e-5 (outputs of order 1 after K = 8 banks and 4 highways)."""
    H = 32
    x = _rand(np.random.default_rng(3), (2, 21, H), 0.5)
    jm, jv, tm = _cbhg_pair(H, "scan", x, 3)
    assert CBHG(H, device="cpu").gru.gru_impl == "scan"
    want = np.asarray(jax.jit(jm.apply)(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    print(f"CBHG scan: max |port - JAX| {np.abs(got - want).max():.3g}")
    np.testing.assert_allclose(got, want, atol=2e-5)


def _jax_variables(jcfg, args, prior, seed):
    model = JText2Vec(jcfg)
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key, "dropout": key}, *args, attn_prior=prior, deterministic=True,
        train_bn=False), jax.random.PRNGKey(0))
    return model, _init_params(shapes["params"], seed), _randomize_stats(shapes["batch_stats"],
                                                                         seed)


def test_text2vec_infer_default_is_scan():
    """Text2Vec.infer of a small default-config model (gru_impl unset) ==
    JAX's: durations and total frames exact, latents atol 1e-4 (f32
    through encoder, decoder and postnet; sums in another order)."""
    rng = np.random.default_rng(4)
    B, N, T_ref, max_frames = 2, 12, 19, 48
    ids = rng.integers(1, JCFG.vocab_size, (B, N)).astype(np.int32)
    ids[1, 9:] = 0
    pos = np.where(ids != 0, np.arange(1, N + 1)[None], 0).astype(np.int32)
    ref = _rand(rng, (B, T_ref, JCFG.n_feat_dim), 0.5)
    batch = make_padded_batch(_items([(12, 64), (9, 40)], 4), CFG)
    train_args = tuple(jnp.asarray(batch[k]) for k in (
        "text", "src_pos", "feat_target", "input_lengths", "output_lengths", "feat_pos"))
    model, params, stats = _jax_variables(JCFG, train_args, jnp.asarray(batch["attn_prior"]), 9)
    lin = params["duration_predictor"]["linear_layer"]["Dense_0"]
    lin["bias"] = lin["bias"] + np.float32(2.0)  # several frames a token
    variables = {"params": params, "batch_stats": stats}
    jout = jax.jit(lambda v, i, p, r: model.apply(v, i, p, r, max_frames, 1.0,
                                                   method=JText2Vec.infer))(
        variables, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(ref))
    port = Text2Vec(CFG, device="cpu")
    assert port.postnet.gru.numerics(B) == "f32"
    port.load_state_dict(weights.text2vec_state_dict(variables, JCFG), strict=True)
    with torch.no_grad():
        out = port.infer(torch.tensor(ids, dtype=torch.int64), torch.tensor(pos),
                         torch.tensor(ref), max_frames, 1.0)
    np.testing.assert_array_equal(out["durations"].numpy(), np.asarray(jout["durations"]))
    np.testing.assert_array_equal(out["total_frames"].numpy(), np.asarray(jout["total_frames"]))
    assert int(out["total_frames"].min()) > 0
    for k in ("feat_output", "feat_postnet_output"):
        err = np.abs(out[k].numpy() - np.asarray(jout[k])).max()
        print(f"infer {k}: max |port - JAX| {err:.3g}")
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), atol=1e-4)


# --- (e) the training steps at the default impl -----------------------------

def _items(lengths, seed):
    rng = np.random.default_rng(seed)
    return [{"text_enc": rng.integers(1, CFG.vocab_size, n).astype(np.int32),
             "feat_gt_target": _rand(rng, (t, CFG.n_feat_dim), 0.5),
             "attn_prior": np.asarray(_prior(n, t))}
            for n, t in lengths]


def _prior(n, t):
    from wavthruvec_pytorch_tpu_torch.data.prior import beta_binomial_prior_distribution
    return beta_binomial_prior_distribution(n, t, 1.0).astype(np.float32)


STEP_LENGTHS = [(12, 64), (9, 60), (5, 57), (7, 50), (16, 64), (10, 62), (8, 40), (11, 58)]


def _jax_step(jcfg, batch, dtype, seed):
    """JAX's loss under value_and_grad for Text2Vec(jcfg, dtype) on seeded
    weights -> (losses, outputs, gradients, starting weights), the last two
    in the port's key layout."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos"))
    _, params, stats = _jax_variables(jcfg, args, jb["attn_prior"], seed)
    model = JText2Vec(jcfg, dtype=dtype)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": stats}, *args,
                             attn_prior=jb["attn_prior"], binarize_attention=True,
                             deterministic=False, train_bn=True,
                             rngs={"dropout": jax.random.PRNGKey(1)}, mutable=["batch_stats"])
        w, p, d = jlosses.dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                   jb["feat_target"], out["duration_predictor_output"],
                                   out["duration"])
        b = jlosses.attention_binarization_loss(out["attn"], out["attn_soft"])
        total = w + p + d + jcfg.binarization_loss_weight * b
        return total, ((total, w, p, d, b), out)

    (_, (jloss, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    start = weights.text2vec_state_dict({"params": params, "batch_stats": stats}, jcfg)
    grads = weights.text2vec_state_dict({"params": _np(jgrads), "batch_stats": stats}, jcfg)
    return [float(v) for v in jloss], _np(jout), grads, start


def _port_step(cfg, start, batch):
    """The port's forward and backward (``Text2VecTrainer``, dtype from
    ``cfg.compute_dtype``) -> (losses, outputs, gradients, the BiGRU input's
    dtype and numerics)."""
    trainer = Text2VecTrainer(cfg, device="cpu")
    trainer.model.load_state_dict(start, strict=True)
    seen = {}
    gru_mod = trainer.model.postnet.gru
    hook = gru_mod.register_forward_pre_hook(
        lambda mod, args: seen.update(dtype=args[0].dtype, numerics=mod.numerics(args[0].shape[0])))
    total, metrics, out = trainer.forward(trainer.to_device(batch))
    hook.remove()
    trainer.backward(total)
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    return [metrics[k].item() for k in metrics], out, grads, seen


@pytest.fixture(scope="module")
def steps():
    """The f32 and bf16 training steps of both packages on the same weights
    and batch (B = 8, text bucket 16, frame bucket 64), gru_impl unset."""
    batch = make_padded_batch(_items(STEP_LENGTHS, 7), CFG)
    res = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        jcfg = dataclasses.replace(JCFG, compute_dtype="float32" if name == "f32" else "bfloat16")
        cfg = dataclasses.replace(CFG, compute_dtype=jcfg.compute_dtype)
        jloss, jout, jgrads, start = _jax_step(jcfg, batch, dtype, 8)
        loss, out, grads, seen = _port_step(cfg, start, batch)
        res[name] = dict(jax_losses=jloss, jax_out=jout, jax_grads=jgrads, losses=loss, out=out,
                         grads=grads, seen=seen)
    return res


def test_f32_step_at_scan(steps):
    """The f32 step at the default impl == JAX's: the BiGRU takes f32 input
    and the f32 numerics; hard alignment and durations equal; the postnet
    output atol 1e-4 (no bf16 rounding of h on either side); the losses rtol
    1e-5; every gradient, the postnet's and ECAPA's included, atol 1e-3 of
    its largest JAX value plus 1e-6 (test_torch_train.py's rule)."""
    s = steps["f32"]
    assert s["seen"] == {"dtype": torch.float32, "numerics": "f32"}
    np.testing.assert_array_equal(s["out"]["attn"].numpy(), s["jax_out"]["attn"])
    np.testing.assert_array_equal(s["out"]["duration"].numpy(), s["jax_out"]["duration"])
    err = np.abs(s["out"]["feat_postnet_output"].detach().numpy()
                 - s["jax_out"]["feat_postnet_output"]).max()
    print(f"feat_postnet_output: max |port - JAX| {err:.3g}")
    assert err <= 1e-4
    np.testing.assert_allclose(s["losses"], s["jax_losses"], rtol=1e-5)
    worst = 0.0
    for name, g in s["grads"].items():
        ref = s["jax_grads"][name].numpy()
        scale = np.abs(ref).max()
        if scale > 1e-5:
            worst = max(worst, np.abs(g.numpy() - ref).max() / scale)
        np.testing.assert_allclose(g.numpy(), ref, atol=1e-3 * scale + 1e-6, err_msg=name)
    print(f"{len(s['grads'])} gradients, worst max |port - JAX| / max |g| {worst:.3g}")


def test_bf16_step_at_scan(steps):
    """The bf16 step (compute_dtype "bfloat16") at the default impl: the
    BiGRU gets f32 input, as JAX's scan does (the highways' f32 Dense layers
    promote), and runs the f32 numerics; hard alignment and durations equal
    JAX's; the losses rtol 2e-2; the gradients within bf16's own noise,
    test_torch_bf16.py's rule: over all tensors ||port - JAX|| <= 1.5
    ||JAX bf16 - JAX f32||, and per module twice that plus 1e-3 of the
    f32 norm."""
    s, f32 = steps["bf16"], steps["f32"]
    assert s["seen"] == {"dtype": torch.float32, "numerics": "f32"}
    assert s["out"]["feat_output"].dtype == torch.bfloat16
    np.testing.assert_array_equal(s["out"]["attn"].numpy(), s["jax_out"]["attn"])
    np.testing.assert_array_equal(s["out"]["duration"].numpy(), s["jax_out"]["duration"])
    np.testing.assert_allclose(s["losses"], s["jax_losses"], rtol=2e-2)
    grads, want, ref = s["grads"], s["jax_grads"], f32["jax_grads"]
    names = [n for n in grads if n in ref]
    assert set(names) == set(grads)

    def dist(a, b, ns):
        return float(np.sqrt(sum(np.linalg.norm(a[n].numpy() - b[n].numpy()) ** 2 for n in ns)))

    zeros = {n: torch.zeros_like(ref[n]) for n in names}
    for mod in sorted({n.split(".")[0] for n in names}):
        ns = [n for n in names if n.split(".")[0] == mod]
        err, noise, norm = dist(grads, want, ns), dist(want, ref, ns), dist(ref, zeros, ns)
        print(f"{mod}: ||port - JAX|| {err / norm:.3g}, ||JAX bf16 - f32|| {noise / norm:.3g}")
        assert err <= 2.0 * noise + 1e-3 * norm, mod
    assert dist(grads, want, names) <= 1.5 * dist(want, ref, names)


# --- (f) "pallas" where JAX's gate refuses: f32 ------------------------------

@pytest.mark.parametrize("B, H, want", [(2, 96, "f32"), (29, 1024, "f32"), (28, 1024, "bf16")])
def test_pallas_impl_follows_jax_gate(B, H, want):
    """A "pallas" BiGRU computes f32 where JAX's gate refuses the shape (H
    % 128 != 0, or B = 29 at H = 1024) and bf16 where it admits it (B = 28),
    as JAX does: atol 1e-5 against JAX BiGRU(impl="pallas") in f32, 1e-4 in
    bf16 (the Pallas kernel in interpret mode, the same bf16 rounding)."""
    x = _rand(np.random.default_rng(B), (B, 3, 16), 0.5)
    jm = jl.BiGRU(hidden=H, impl="pallas")
    v = jm.init(jax.random.PRNGKey(B), jnp.asarray(x))
    want_y = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = tl.BiGRU(16, H, gru_impl="pallas", device="cpu")
    assert tm.numerics(B) == want
    tm.load_state_dict(_bigru_state(v["params"]), strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    err = np.abs(got - want_y).max()
    print(f"B={B} H={H} ({want}): max |port - JAX pallas| {err:.3g}")
    np.testing.assert_allclose(got, want_y, atol=GRU_ATOL if want == "f32" else 1e-4)
    if want == "f32":  # JAX took its scan: the bf16 numerics would fail the tolerance
        with torch.no_grad():
            bf16 = gru.gru_fwd_plain(*tm.recurrence_inputs(_t(x))).numpy()
        assert np.abs(np.concatenate([bf16[0], np.flip(bf16[1], 1)], -1) - want_y).max() > GRU_ATOL


# --- (g) the f32 kernel's plan at an H100's limits ---------------------------

@pytest.mark.parametrize("B", [1, 2, 8, 16, 32, 40])
def test_f32_plan_persistent_at_cbhg_shapes(B):
    """At D = 2, H = 1024 the f32 kernel is one persistent launch on an
    H100 up to B = 40 (B = 32, where JAX's gate sends "pallas" to f32 too,
    included): 16 units a block, 128 blocks, the block's 48 rows of f32
    w_hh (196,608 bytes) resident, its shared memory the kernel's formula
    and within the card's 232,448 bytes a block."""
    plan = gru.gru_fwd_plan(2, B, 1024, H100_SMS, H100_SMEM, "f32")
    assert plan.route == "persistent" and (plan.units, plan.blocks) == (16, 128)
    assert plan.smem == gru.persistent_f32_smem(16, B, 1024) <= H100_SMEM
    assert plan.smem >= 3 * 16 * 1024 * 4 > gru.persistent_smem(16, B, 1024)


@pytest.mark.parametrize("D, B, H", [(2, 41, 1024), (2, 64, 1024), (2, 4, 2048), (4, 1, 1024)])
def test_f32_plan_steps_where_it_does_not_fit(D, B, H):
    """Where the f32 slice and its buffers overflow a block's shared memory
    (B >= 41 at H = 1024, H = 2048) or the blocks outnumber the SMs, the f32
    kernel takes the one-launch-a-step route."""
    plan = gru.gru_fwd_plan(D, B, H, H100_SMS, H100_SMEM, "f32")
    assert plan.route == "steps" and plan.units == 8 and plan.smem == 0
    assert plan.blocks == D * H // 8


def test_f32_wrapper_takes_plain_only_on_cpu():
    """gru_fwd_f32 runs the plain version on CPU tensors and launches
    nothing; on any other device it raises, as gru_fwd does, and it refuses
    a bf16 w_hh where a CUDA tensor would reach the kernel."""
    gi, w, b = torch.randn(2, 1, 5, 48), torch.randn(2, 16, 48), torch.randn(2, 48)
    before = (gru.gru_fwd_f32.launches, gru.gru_fwd_f32.step_launches, gru.gru_fwd.launches)
    gru.gru_fwd_f32(gi, w, b)
    assert (gru.gru_fwd_f32.launches, gru.gru_fwd_f32.step_launches,
            gru.gru_fwd.launches) == before
    with pytest.raises(ValueError):
        gru.gru_fwd_f32(gi.to("meta"), w.to("meta"), b.to("meta"))
    with pytest.raises(ValueError):
        gru.gru_fwd_steps(gi, w, b)  # CPU tensors: no plain path
