"""The bf16 GAN step (``GANTrainer`` with ``compute_dtype="bfloat16"``)
against the JAX package's (``init_state(compute_dtype="bfloat16")`` then
``train_step``) on the CPU, from the same weights, noise and batch.

The config is ``tests/test_torch_gan_step.py``'s (the JAX package's tiny
GAN-step config, the discriminators at their full widths) at B = 2, T = 16
latent frames (256 samples).  JAX's f32 step from the same weights sets the
scale of bf16's own noise: its convolutions round to bf16 at other sums in
the two packages (XLA's and PyTorch's CPU convolutions), and a rounding
that flips feeds every layer after it.

Tolerances.  The dtypes are JAX's exactly: a bf16 waveform and D loss, f32
mel and G losses.  ``NOISE_FACTOR`` is below 1, so that a computation in
f32, which lies at 1 times JAX's bf16-vs-f32 distance, fails it.

* Each module's train-mode forward from the step's weights and inputs
  (Generator, MPD, MSD; every output and feature map): ||port - JAX bf16||
  at most ``NOISE_FACTOR`` times ||JAX bf16 - JAX f32||, and the port's
  f32 forward must fail that bound.  Observed: 0.31, 0.26 and 0.25 of the
  distance (the same roundings, sums in another order), the f32 forward
  1.00.
* Each loss after the step: |port - JAX bf16| at most ``NOISE_FACTOR``
  times |JAX bf16 - JAX f32|, or 2^-8 of the loss (one bf16 ulp: the D loss
  is a bf16 number), whichever is larger.  Observed: the G and mel losses
  8.7e-4 of the loss apart, 0.2 of the floor.  At this size bf16 moves
  the losses by less than one ulp, so this bound does not tell bf16 from
  f32; the forward does.
* The state after the step (parameters, the Generator's running
  statistics, every spectral vector), per module: ||port - JAX bf16|| at
  most ``STATE_NOISE_FACTOR`` times ||JAX bf16 - JAX f32||.  The
  parameters' difference is their AdamW updates' (the same weights
  before), whose first step is sign-like, so the distance counts the
  gradients whose sign any rounding flips: it reads 0.84-0.94 of the
  distance for the port, near 1 for f32 too, and guards against a step
  gone wrong, not against f32.

The f32 step is held in ``tests/test_torch_gan_step.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_gan_step import CFG, JCFG, _np
from wavthruvec_pytorch_tpu.checkpoint import (
    import_vec2wav_generator,
    import_vec2wav_mpd,
    import_vec2wav_msd,
)
from wavthruvec_pytorch_tpu.checkpoint import load_torch_state_dict as jax_load_torch_state_dict
from wavthruvec_pytorch_tpu.models import vec2wav as jv
from wavthruvec_pytorch_tpu.ops.stft import mel_spectrogram as jax_mel
from wavthruvec_pytorch_tpu.train import vec2wav_train as jtrain
from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer

B, T = 2, 16
NOISE_FACTOR = 0.5
STATE_NOISE_FACTOR = 2.0
LOSS_RTOL_FLOOR = 2.0 ** -8
JCFG_BF16 = dataclasses.replace(JCFG, compute_dtype="bfloat16")
CFG_BF16 = dataclasses.replace(CFG, compute_dtype="bfloat16")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((B, T * JCFG.total_upsample, 1)) * 0.1).astype(np.float32)
    mel = np.asarray(jax_mel(jnp.asarray(audio[..., 0]), JCFG.n_fft, JCFG.num_mels,
                             JCFG.sampling_rate, JCFG.hop_size, JCFG.win_size, JCFG.fmin,
                             JCFG.fmax_for_loss)).transpose(0, 2, 1)
    return {"wv_feat": rng.standard_normal((B, T, JCFG.n_feat_dim)).astype(np.float32),
            "spk_emb": rng.standard_normal((B, JCFG.spk_dim)).astype(np.float32),
            "audio": audio, "mel_loss": mel}


def _state_dicts(state):
    """A JAX state's modules in the port's key layout: {module: {key: tensor}}."""
    gen = weights.generator_state_dict({"params": state.gen_params,
                                        "batch_stats": state.gen_batch_stats,
                                        "spectral": state.gen_spectral}, JCFG)
    mpd = weights.mpd_state_dict({"params": state.disc_params["mpd"]}, JCFG)
    msd = weights.msd_state_dict({"params": state.disc_params["msd"],
                                  "spectral": state.msd_spectral})
    return {"gen": gen, "mpd": mpd, "msd": msd}


def _jax_models(cfg):
    """JAX ``init_state``'s modules for ``cfg`` (train/vec2wav_train.py:80-91)."""
    dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else None
    return jtrain.V2WModels(
        jv.Generator(cfg, dtype=dtype),
        jv.MultiPeriodDiscriminator(cfg, dtype=dtype, pair_batched=cfg.disc_pair_batched),
        jv.MultiScaleDiscriminator(dtype=dtype, pair_batched=cfg.disc_pair_batched,
                                   tiled_conv=cfg.msd_tiled_conv))


@pytest.fixture(scope="module")
def steps():
    """The port's bf16 step and JAX's bf16 and f32 steps from one set of
    weights (a seeded port init, imported into JAX by its own importers;
    flax keeps the parameters f32 in either dtype), one batch and one noise
    draw."""
    torch.manual_seed(0)
    trainer = GANTrainer(CFG_BF16, device="cpu")
    sd = {name: {k: v.numpy() for k, v in m.state_dict().items()}
          for name, m in (("gen", trainer.gen), ("mpd", trainer.mpd), ("msd", trainer.msd))}
    gen, mpd = import_vec2wav_generator(sd["gen"], JCFG), import_vec2wav_mpd(sd["mpd"], JCFG)
    msd = import_vec2wav_msd(sd["msd"])
    disc = {"mpd": mpd["params"], "msd": msd["params"]}
    opt_g, opt_d = jtrain.make_optimizers(JCFG)
    state = jtrain.GANTrainState(
        step=jnp.zeros((), jnp.int32), gen_params=gen["params"],
        gen_batch_stats=gen["batch_stats"], gen_spectral=gen["spectral"], disc_params=disc,
        msd_spectral=msd["spectral"], opt_g_state=opt_g.init(gen["params"]),
        opt_d_state=opt_d.init(disc))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rng = jax.random.PRNGKey(1)
    out = {}
    for name, cfg in (("bf16", JCFG_BF16), ("f32", JCFG)):
        models = _jax_models(cfg)
        new_state, metrics = jax.jit(lambda s, b, m=models, c=cfg: jtrain.train_step(
            m, c, opt_g, opt_d, s, b, rng))(state, batch)
        out[name] = (_state_dicts(_np(new_state)), _np(metrics))
    noise = torch.tensor(np.asarray(jax.random.normal(rng, (B, JCFG.noise_dim))))
    metrics = trainer.step(_batch(), noise=noise)
    port = {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in (("gen", trainer.gen), ("mpd", trainer.mpd), ("msd", trainer.msd))}
    return out, port, metrics, trainer


def _flat(out) -> np.ndarray:
    """A module's outputs and feature maps in JAX's channels-last layout,
    flattened into one f32 vector."""
    if isinstance(out, (list, tuple)):
        return np.concatenate([_flat(o) for o in out])
    if isinstance(out, torch.Tensor):
        t = out.detach().float()
        return (t.movedim(1, -1) if t.dim() >= 3 else t).numpy().ravel()
    return np.asarray(jnp.asarray(out, jnp.float32)).ravel()


@pytest.fixture(scope="module")
def forwards():
    """Each module's train-mode forward from the step's weights (the same
    seeded init as ``steps``): the Generator on the step's batch and noise,
    the discriminators on the batch's audio against it reversed in time;
    {module: {"bf16" | "f32": (port, JAX)}} as flat vectors.  JAX's
    Generator runs op by op, each bf16 rounding where flax puts it (under
    ``jit`` XLA's default excess precision keeps some of its fused
    intermediates in f32); the discriminators, whose roundings ``jit``
    keeps, run compiled."""
    torch.manual_seed(0)
    bf16 = GANTrainer(CFG_BF16, device="cpu")
    f32 = GANTrainer(CFG, device="cpu")
    for a, b in ((f32.gen, bf16.gen), (f32.mpd, bf16.mpd), (f32.msd, bf16.msd)):
        a.load_state_dict(b.state_dict())
    # copies: the port's train-mode forward moves its spectral vectors in place
    sd = {name: {k: v.clone().numpy() for k, v in m.state_dict().items()}
          for name, m in (("gen", bf16.gen), ("mpd", bf16.mpd), ("msd", bf16.msd))}
    jvars = {"gen": import_vec2wav_generator(sd["gen"], JCFG),
             "mpd": import_vec2wav_mpd(sd["mpd"], JCFG), "msd": import_vec2wav_msd(sd["msd"])}
    b = _batch()
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, JCFG.noise_dim)))
    y, y_rev = b["audio"], np.ascontiguousarray(b["audio"][:, ::-1])
    out = {"gen": {}, "mpd": {}, "msd": {}}
    for name, jcfg, trainer in (("bf16", JCFG_BF16, bf16), ("f32", JCFG, f32)):
        m = _jax_models(jcfg)
        x, spk, z, a, a_rev = (jnp.asarray(v) for v in (b["wv_feat"], b["spk_emb"], noise, y,
                                                        y_rev))
        y_hat, _ = m.gen.apply(jvars["gen"], x, spk, z, train=True,
                               mutable=["batch_stats", "spectral"])
        msd, _ = jax.jit(lambda v, p, q, m=m: m.msd.apply(v, p, q, mutable=["spectral"]))(
            jvars["msd"], a, a_rev)
        want = (y_hat, jax.jit(m.mpd.apply)(jvars["mpd"], a, a_rev), msd)
        for mod in (trainer.gen, trainer.mpd, trainer.msd):
            mod.train()
        with torch.no_grad():
            got = (trainer.gen(torch.tensor(b["wv_feat"]), torch.tensor(b["spk_emb"]),
                               torch.tensor(noise)),
                   trainer.mpd(torch.tensor(y), torch.tensor(y_rev)),
                   trainer.msd(torch.tensor(y), torch.tensor(y_rev)))
        for key, g, w in zip(("gen", "mpd", "msd"), got, want):
            out[key][name] = (_flat(g), _flat(w))
    return out


@pytest.mark.parametrize("module", ["gen", "mpd", "msd"])
def test_bf16_forward_matches_jax_bf16(forwards, module):
    """The port's bf16 forward within ``NOISE_FACTOR`` of JAX's
    bf16-vs-f32 distance; the port's f32 forward outside it."""
    (port, jb), (port_f32, jf) = forwards[module]["bf16"], forwards[module]["f32"]
    noise = float(np.linalg.norm(jb - jf))
    err, err_f32 = float(np.linalg.norm(port - jb)), float(np.linalg.norm(port_f32 - jb))
    print(f"{module}: ||port bf16 - JAX bf16|| {err:.4g}, ||port f32 - JAX bf16|| {err_f32:.4g}, "
          f"||JAX bf16 - JAX f32|| {noise:.4g}")
    assert noise > 0 and err <= NOISE_FACTOR * noise
    assert err_f32 > NOISE_FACTOR * noise


def test_bf16_step_dtypes(steps):
    """The modules compute in bf16 with f32 parameters and f32 AdamW state;
    the scalars take JAX's dtypes (the D loss bf16, the rest f32)."""
    out, _, metrics, trainer = steps
    for k in SCALAR_KEYS:
        want = str(out["bf16"][1][k].dtype)
        assert metrics[k].dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[want], k
    assert metrics["disc_loss_total"].dtype == torch.bfloat16
    for module in (trainer.gen, trainer.mpd, trainer.msd):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    for opt in (trainer.opt_g, trainer.opt_d):
        assert all(v.dtype == torch.float32 for st in opt.state.values() for k, v in st.items()
                   if k != "step")
    batch = trainer.to_device(_batch())
    y_hat = trainer.generate(batch, noise=torch.zeros(B, CFG.noise_dim))
    assert y_hat.dtype == torch.bfloat16
    assert trainer.msd(batch["audio"], y_hat)[0][0].dtype == torch.bfloat16


def test_bf16_step_losses(steps):
    out, _, metrics, _ = steps
    (_, jb), (_, jf) = out["bf16"], out["f32"]
    for k in SCALAR_KEYS:
        got, want, f32 = float(metrics[k]), float(jb[k]), float(jf[k])
        noise = abs(want - f32)
        print(f"{k}: port {got:.6g}, JAX bf16 {want:.6g}, JAX f32 {f32:.6g}")
        assert abs(got - want) <= max(NOISE_FACTOR * noise, LOSS_RTOL_FLOOR * abs(want)), k


def test_bf16_step_state(steps):
    """Per module, over every float entry of its state after the step."""
    out, port, _, _ = steps
    (jb, _), (jf, _) = out["bf16"], out["f32"]
    for mod in ("gen", "mpd", "msd"):
        keys = [k for k, v in jb[mod].items() if v.is_floating_point()]
        assert set(keys) <= set(port[mod])
        err = float(torch.sqrt(sum(((port[mod][k] - jb[mod][k]) ** 2).sum() for k in keys)))
        noise = float(torch.sqrt(sum(((jf[mod][k] - jb[mod][k]) ** 2).sum() for k in keys)))
        print(f"{mod}: ||port - JAX bf16|| {err:.4g}, ||JAX bf16 - JAX f32|| {noise:.4g}")
        assert noise > 0 and err <= STATE_NOISE_FACTOR * noise, mod


def test_bf16_step_files_serve_from_either_package(steps, tmp_path):
    """The bf16 trainer's ``g_``/``do_`` files hold f32 tensors (its
    parameters, statistics and AdamW state never leave f32), as every file
    of the port does.  Its ``g_`` serves from the port's f32 Generator and
    from JAX's, imported by ``import_vec2wav_generator``: the two waveforms
    agree at the f32 Generator's tolerance, atol 2e-4."""
    _, _, _, trainer = steps
    ckpt.save_vec2wav(str(tmp_path), 0, trainer, 0)
    g_file, do_file = ckpt.latest_vec2wav(str(tmp_path))
    do = torch.load(do_file, map_location="cpu", weights_only=False)
    tensors = [v for part in ("mpd", "msd") for v in do[part].values()]
    tensors += [v for opt in ("optim_g", "optim_d") for st in do[opt]["state"].values()
                for k, v in st.items() if k != "step"]
    g = jax_load_torch_state_dict(g_file, "generator")
    assert all(v.dtype == np.float32 for v in g.values() if v.dtype.kind == "f")
    assert all(v.dtype == torch.float32 for v in tensors if v.is_floating_point())
    gen = Generator(CFG_BF16, device="cpu")  # serving: f32 whatever the config says
    gen.load_state_dict(ckpt.load_torch_state_dict(g_file, "generator"), strict=True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, JCFG.n_feat_dim)).astype(np.float32)
    spk = rng.standard_normal((1, JCFG.spk_dim)).astype(np.float32)
    z = rng.standard_normal((1, JCFG.noise_dim)).astype(np.float32)
    want = jax.jit(lambda v, *a: jv.Generator(JCFG_BF16, fused=False).apply(v, *a, train=False))(
        import_vec2wav_generator(g, JCFG_BF16), *(jnp.asarray(a) for a in (x, spk, z)))
    assert want.dtype == jnp.float32  # JAX's Generator reads no compute_dtype either
    got = gen(*(torch.from_numpy(a) for a in (x, spk, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
