"""The port's bf16 compute (flax's per-layer ``dtype``) and its bf16 + flash
training step against the JAX package on the CPU.

Layers: the port's ``Linear``, ``Conv1d``, ``LayerNorm`` and ``BatchNorm``
with a dtype against flax's, on the same bf16-representable inputs.  The
step: a T2V_SMALL-shaped model (``n_feat_dim`` 128 and ``gru_impl="pallas"``
as in ``test_torch_train.py``) with ``compute_dtype="bfloat16"`` and
``flash_attention=True``, B = 8, text bucket 256 and frame bucket 512, so
both FFT stacks pass the flash gate: the port runs the flash kernels' plain
version, JAX (whose gate asks for a TPU) its dense branch.  The priors are
diagonal (1 at text position floor(i n / t) of frame i, 1e-4 elsewhere): any
path but the diagonal costs 9.2 a frame in log-probability, so MAS has no
near-ties, and hard alignments and durations must be equal.  The same model,
weights and batch in f32 (``compute_dtype="float32"``, still flash) make the
f32 flash step, held to the f32 step's tolerances of ``test_torch_train.py``
(``test_torch_bf16_flash.py``, with the long-bucket config's checks).

Tolerances.  A layer: 2^-8 of its largest output, one bf16 rounding (the
sums are f32 in both; observed equal).  The step: bf16 rounds at other sums in
the two packages, and the port rounds the attention probabilities to bf16
where JAX's dense branch keeps them f32; a rounding that flips feeds every
layer after it.  Losses rtol 2e-2.  Gradients are held to bf16's own noise:
the distance ||port - JAX|| of each module's gradients (ECAPA, the encoder's
FFT stack, the decoder, ...) may be at most twice the distance of JAX's bf16
gradients from the f32 step's (the port's f32 step on the same weights,
which equals JAX's f32 step to 2.7e-4 of its largest gradient,
``test_torch_train.py``), plus 1e-3 of the f32 norm; over all tensors at
most 1.5 times.  Observed: JAX's bf16 gradients lie 0.14 of the norm from
f32, the port's 0.12 from JAX's, most of it in ECAPA, whose pooling
subtracts two bf16 sums (E[x^2 w] - mu^2) and whose batch-wide BatchNorms
leave several gradients 0 but for rounding.
"""

import dataclasses
import os

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
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.models import layers as tl
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.ops import flash_attention as fa
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LONG_CFG = os.path.join(REPO, "artifacts", "flash_longbucket", "flash", "longbucket",
                        "config.json")
LAYER_RTOL = 2.0 ** -8
STEP_LOSS_RTOL = 2e-2
GRAD_NOISE_FACTOR = 2.0          # per module, times JAX's bf16-vs-f32 distance
GRAD_NOISE_FACTOR_GLOBAL = 1.5   # over all tensors
N_BUCKET, T_BUCKET = 256, 512
JCFG = dataclasses.replace(
    T2V_SMALL, n_feat_dim=128, gru_impl="pallas", dropout=0.0, vocab_size=300,
    max_seq_len=T_BUCKET, text_buckets=(N_BUCKET,), frame_buckets=(T_BUCKET,),
    grad_clip_every=1, learning_rate=0.01, compute_dtype="bfloat16", flash_attention=True)
CFG = Text2VecConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(Text2VecConfig)})
# the same model, batch and buckets in f32 with flash, held as the f32 step of
# test_torch_train.py: losses rtol 1e-5, gradients atol 1e-3 of each tensor's largest
JCFG_F32 = dataclasses.replace(JCFG, compute_dtype="float32")
CFG_F32 = dataclasses.replace(CFG, compute_dtype="float32")
F32_LOSS_RTOL = 1e-5
F32_GRAD_RTOL = 1e-3
# ... except below the BiGRU's bf16 rounding of h, held as chip_smoke.py holds the
# card's f32 step (STEP_GRAD_RTOL, STEP_GRAD_GLOBAL_RTOL): ||port - JAX|| / ||JAX||
F32_FLIP_MODULES = ("postnet", "encoder.speaker_encoder")
F32_FLIP_GRAD_RTOL = 3e-2
F32_FLIP_GRAD_GLOBAL_RTOL = 5e-3


def _bf16_values(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32).bfloat16().float()


def _layer_case(kind):
    """(flax module, port module, export rows, input) of one layer."""
    if kind == "linear":
        return (jl.Linear(7, dtype=jnp.bfloat16), tl.Linear(12, 7, dtype=torch.bfloat16,
                                                           device="cpu"),
                [("lin", "m.linear_layer", "m/Dense_0")], _bf16_values((2, 5, 12), 0))
    if kind == "conv1d":
        return (jl.Conv1d(6, kernel_size=3, padding=1, dtype=jnp.bfloat16),
                tl.Conv1d(10, 6, 3, padding=1, dtype=torch.bfloat16, device="cpu"),
                [("conv", "m", "m/Conv_0")], _bf16_values((2, 9, 10), 1))
    if kind == "layer_norm":
        return (jl.LayerNorm(dtype=jnp.bfloat16), tl.LayerNorm(10, dtype=torch.bfloat16,
                                                                 device="cpu"),
                [("ln", "m", "m/LayerNorm_0")], _bf16_values((2, 9, 10), 2, 3.0) + 1.0)
    # BatchNorm with no dtype on a bf16 input, train mode: statistics in f32, f32 out
    return (jl.BatchNorm(use_running_average=False), tl.BatchNorm(10, device="cpu").train(),
            [("bn", "m", "m")], _bf16_values((4, 9, 10), 3, 2.0).bfloat16())


@pytest.mark.parametrize("kind", ["linear", "conv1d", "layer_norm", "batch_norm"])
def test_layer_dtype_matches_flax(kind):
    """Output dtype equal to flax's and values within 2^-8 of the largest;
    the parameters' gradients are f32."""
    jm, tm, rows, x = _layer_case(kind)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if x.dtype == torch.bfloat16
                                                else jnp.float32)
    jv = _np(jm.init(jax.random.PRNGKey(0), jx))
    if kind == "batch_norm":
        want, _ = jm.apply(jv, jx, mutable=["batch_stats"])
    else:
        want = jm.apply(jv, jx)
    sd = weights._to_torch(weights._export({c: {"m": t} for c, t in jv.items()}, rows))
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    got = tm(x)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got_np, want_np = got.detach().float().numpy(), np.asarray(want.astype(jnp.float32))
    err = np.abs(got_np - want_np).max() / np.abs(want_np).max()
    print(f"{kind}: {got.dtype}, max |port - flax| / max |flax| {err:.3g}")
    assert err <= LAYER_RTOL
    got.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in tm.parameters())


def _items(lengths, seed):
    rng = np.random.default_rng(seed)
    items = []
    for n, t in lengths:
        prior = np.full((t, n), 1e-4, np.float32)
        prior[np.arange(t), np.arange(t) * n // t] = 1.0
        items.append({"text_enc": rng.integers(1, CFG.vocab_size, n).astype(np.int32),
                      "feat_gt_target": (rng.standard_normal((t, CFG.n_feat_dim))
                                         * 0.5).astype(np.float32),
                      "attn_prior": prior})
    return items


# (text, frames) of the step's batch: 1.5-2 frames a character, the longest
# filling both buckets
STEP_LENGTHS = [(256, 512), (200, 380), (130, 250), (170, 330), (240, 470), (150, 260),
                (190, 300), (228, 400)]


def _jax_step(jcfg, batch, dtype):
    """JAX's side of one training step: ``train_step``'s loss under
    ``value_and_grad`` with ``Text2Vec(jcfg, dtype=dtype)`` (as ``init_state``
    builds it for the config's ``compute_dtype``) on seeded weights ->
    (losses, outputs, gradients and the starting weights in the port's key
    layout)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos"))
    model = JText2Vec(jcfg, dtype=dtype)
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key, "dropout": key}, *args, attn_prior=jb["attn_prior"],
        deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 12)
    stats = _randomize_stats(shapes["batch_stats"], 12)

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


def _port_step(trainer, batch):
    """The port's forward and backward on ``batch`` (the flash kernels' plain
    version: no kernel launches) -> (losses, outputs, gradients)."""
    launches = (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    total, metrics, out = trainer.forward(trainer.to_device(batch))
    trainer.backward(total)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches) == launches
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters() if p.grad is not None}
    return [metrics[k].item() for k in metrics], out, grads


@pytest.fixture(scope="module")
def bf16_step():
    """One bf16 + flash training step of each package on the same weights
    and batch; the JAX side is ``train_step``'s loss under
    ``value_and_grad`` with ``Text2Vec(cfg, dtype=jnp.bfloat16)``, as
    ``init_state`` builds it for ``compute_dtype="bfloat16"``."""
    batch = make_padded_batch(_items(STEP_LENGTHS, seed=11), CFG)
    assert batch["text"].shape == (8, N_BUCKET) and batch["feat_target"].shape[1] == T_BUCKET
    jax_losses, jax_out, jax_grads, start = _jax_step(JCFG, batch, jnp.bfloat16)

    trainer = Text2VecTrainer(CFG, device="cpu")  # bf16 from compute_dtype
    trainer.model.load_state_dict(start, strict=True)
    losses, out, grads = _port_step(trainer, batch)
    trainer.apply_gradients()

    # the f32 step on the same weights: the reference for bf16's own noise
    f32 = Text2VecTrainer(CFG, device="cpu", model=Text2Vec(CFG, device="cpu"))
    f32.model.load_state_dict(start, strict=True)
    f32.backward(f32.forward(f32.to_device(batch))[0])
    f32_grads = {n: p.grad for n, p in f32.model.named_parameters() if p.grad is not None}
    return dict(jax_losses=jax_losses, jax_out=jax_out, jax_grads=jax_grads, losses=losses,
                out=out, grads=grads, f32_grads=f32_grads, trainer=trainer)


def test_bf16_step_alignment_and_outputs(bf16_step):
    """Hard alignment and durations equal JAX's exactly; the model is bf16
    where JAX's is (feat_output is bf16 in both, the duration predictor f32)."""
    out, jout = bf16_step["out"], bf16_step["jax_out"]
    np.testing.assert_array_equal(out["attn"].numpy(), jout["attn"])
    np.testing.assert_array_equal(out["duration"].numpy(), jout["duration"])
    for k in ("feat_output", "feat_postnet_output", "duration_predictor_output", "attn_soft"):
        assert str(out[k].dtype).split(".")[-1] == str(jout[k].dtype), k
        got, want = out[k].detach().float().numpy(), np.asarray(jout[k], np.float32)
        print(f"{k} ({out[k].dtype}): max |port - JAX| {np.abs(got - want).max():.3g} "
              f"(max |JAX| {np.abs(want).max():.3g})")
    assert bf16_step["trainer"].step_count == 1
    assert all(p.dtype == torch.float32 for p in bf16_step["trainer"].params)


def test_bf16_step_losses(bf16_step):
    """The five losses == JAX's: rtol 2e-2."""
    print("losses port", bf16_step["losses"], "JAX", bf16_step["jax_losses"])
    np.testing.assert_allclose(bf16_step["losses"], bf16_step["jax_losses"], rtol=STEP_LOSS_RTOL)


def _module(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "encoder" else parts[0]


def _dist(a, b, names) -> float:
    return float(np.sqrt(sum(np.linalg.norm(a[n].numpy() - b[n].numpy()) ** 2 for n in names)))


def test_bf16_step_gradients(bf16_step):
    """Every gradient is f32 and == JAX's mapped through the weight bridge,
    within bf16's own noise: per module ||port - JAX|| <= 2 ||JAX - f32|| +
    1e-3 ||f32||, over all tensors 1.5 ||JAX - f32||."""
    grads, want, f32 = bf16_step["grads"], bf16_step["jax_grads"], bf16_step["f32_grads"]
    assert set(grads) == set(f32)
    assert all(g.dtype == torch.float32 for g in grads.values())
    zeros = {n: torch.zeros_like(g) for n, g in f32.items()}
    for mod in sorted({_module(n) for n in grads}):
        names = [n for n in grads if _module(n) == mod]
        err, noise = _dist(grads, want, names), _dist(want, f32, names)
        norm = _dist(f32, zeros, names)
        print(f"{mod} ({len(names)} tensors): ||port - JAX|| {err / norm:.3g}, "
              f"||JAX - f32|| {noise / norm:.3g} of ||f32||")
        assert err <= GRAD_NOISE_FACTOR * noise + 1e-3 * norm, mod
    names = list(grads)
    err, noise, norm = _dist(grads, want, names), _dist(want, f32, names), _dist(f32, zeros, names)
    print(f"all {len(names)} gradients: ||port - JAX|| {err / norm:.3g}, ||JAX - f32|| "
          f"{noise / norm:.3g} of ||f32||")
    assert err <= GRAD_NOISE_FACTOR_GLOBAL * noise
