"""One Vec2Wav GAN step of the port against the JAX package's
``train_step`` on the CPU.

The config is the JAX package's tiny GAN-step config
(``tests/test_train_steps.py``: ``V2W_SMALL`` with n_fft 64, hop 16, 8 mel
bins; the discriminators at their fixed full widths) at B = 2, T = 4 latent
frames (64 samples).  JAX's variables after ``init_state`` are carried into
the port by ``weights.py``; JAX's noise draw is passed to ``GANTrainer.step``.
The JAX step is compiled once for the module, together with its D and G
gradients (the step's ``d_loss_fn`` and ``g_loss_fn`` rebuilt).

Tolerances (f32 on both sides, sums in another order): the four scalars
rtol 1e-5; each gradient atol 1e-4 of its tensor's largest value; the new
BatchNorm statistics and spectral vectors atol 1e-5.  The parameters after
the AdamW step: AdamW's first step is sign-like (m_hat / sqrt(v_hat) = +-1
wherever |g| >> eps), so a gradient that rounding moves across 0 moves its
parameter by up to 2 lr in the other direction, and near |g| ~ eps the
step g / (|g| + eps) magnifies a rounding of g.  Where the two gradients
agree in sign and |g| exceeds 1e-4 (so eps / |g| <= 1e-4) the parameters
agree to atol 1e-6; every other entry is held to 2 lr + 1e-6, and at most
0.1% of all entries may differ past 1e-6.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_models import V2W_SMALL
from wavthruvec_pytorch_tpu.ops.stft import mel_spectrogram as jax_mel
from wavthruvec_pytorch_tpu.models.vec2wav import (
    discriminator_loss as j_disc_loss,
    feature_loss as j_feat_loss,
    generator_loss as j_gen_loss,
)
from wavthruvec_pytorch_tpu.train import vec2wav_train as jtrain
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import mel_spectrogram_np, pad_vocoder_batch
from wavthruvec_pytorch_tpu_torch.models.vec2wav import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import (
    SCALAR_KEYS,
    GANTrainer,
    set_learning_rate,
)

JCFG = dataclasses.replace(V2W_SMALL, n_fft=64, win_size=64, hop_size=16, num_mels=8,
                           fmax_for_loss=None)
CFG = Vec2WavConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(Vec2WavConfig)})
B, T = 2, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    L = T * JCFG.total_upsample
    audio = (rng.standard_normal((B, L, 1)) * 0.1).astype(np.float32)
    mel = np.asarray(jax_mel(jnp.asarray(audio[..., 0]), JCFG.n_fft, JCFG.num_mels,
                             JCFG.sampling_rate, JCFG.hop_size, JCFG.win_size, JCFG.fmin,
                             JCFG.fmax_for_loss)).transpose(0, 2, 1)
    return {"wv_feat": rng.standard_normal((B, T, JCFG.n_feat_dim)).astype(np.float32),
            "spk_emb": rng.standard_normal((B, JCFG.spk_dim)).astype(np.float32),
            "audio": audio, "mel_loss": mel}


def _jax_grads(models, state, batch, noise):
    """The gradients of JAX's D and G losses at ``state``, from the loss
    functions of ``train_step`` (train/vec2wav_train.py:170-230), rebuilt."""
    y = batch["audio"]
    gvars = {"params": state.gen_params, "batch_stats": state.gen_batch_stats,
             "spectral": state.gen_spectral}
    y_hat, _ = models.gen.apply(gvars, batch["wv_feat"], batch["spk_emb"], noise, train=True,
                                mutable=["batch_stats", "spectral"])
    y_hat_sg = jax.lax.stop_gradient(y_hat)

    def d_loss_fn(dp):
        r, g, _, _ = models.mpd.apply({"params": dp["mpd"]}, y, y_hat_sg)
        msd_vars = {"params": dp["msd"], "spectral": state.msd_spectral}
        (rs, gs, _, _), mut = models.msd.apply(msd_vars, y, y_hat_sg, mutable=["spectral"])
        return j_disc_loss(r, g)[0] + j_disc_loss(rs, gs)[0], mut["spectral"]

    d_grads, msd_spectral_1 = jax.grad(d_loss_fn, has_aux=True)(state.disc_params)
    opt_d = jtrain.make_optimizers(JCFG)[1]
    updates, _ = opt_d.update(d_grads, state.opt_d_state, state.disc_params)
    new_d = optax.apply_updates(state.disc_params, updates)

    def g_loss_fn(gp):
        y_g, _ = models.gen.apply(dict(gvars, params=gp), batch["wv_feat"], batch["spk_emb"], noise,
                                  train=True, mutable=["batch_stats", "spectral"])
        y_g_mel = jax_mel(y_g[..., 0], JCFG.n_fft, JCFG.num_mels, JCFG.sampling_rate,
                          JCFG.hop_size, JCFG.win_size, JCFG.fmin,
                          JCFG.fmax_for_loss).transpose(0, 2, 1)
        loss_mel = jnp.mean(jnp.abs(batch["mel_loss"][:, :y_g_mel.shape[1]] - y_g_mel)) * 45.0
        _, g, fr, fg = models.mpd.apply({"params": new_d["mpd"]}, y, y_g)
        msd_vars = {"params": new_d["msd"], "spectral": msd_spectral_1}
        (_, gs, fsr, fsg), _ = models.msd.apply(msd_vars, y, y_g, mutable=["spectral"])
        return (j_gen_loss(gs)[0] + j_gen_loss(g)[0] + j_feat_loss(fsr, fsg)
                + j_feat_loss(fr, fg) + loss_mel)

    return d_grads, jax.grad(g_loss_fn)(state.gen_params)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's state before and after one step, its metrics, noise and
    gradients, from one compiled program."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    models, state = jtrain.init_state(JCFG, jax.random.PRNGKey(0), batch)
    opt_g, opt_d = jtrain.make_optimizers(JCFG)
    rng = jax.random.PRNGKey(1)

    @jax.jit
    def run(state, batch):
        noise = jax.random.normal(rng, (B, JCFG.noise_dim))
        new_state, metrics = jtrain.train_step(models, JCFG, opt_g, opt_d, state, batch, rng)
        return new_state, metrics, noise, _jax_grads(models, state, batch, noise)

    new_state, metrics, noise, (d_grads, g_grads) = run(state, batch)
    return dict(state=_np(state), new_state=_np(new_state), metrics=_np(metrics),
                noise=np.asarray(noise), d_grads=_np(d_grads), g_grads=_np(g_grads))


def _gen_vars(state, params=None):
    return {"params": state.gen_params if params is None else params,
            "batch_stats": state.gen_batch_stats, "spectral": state.gen_spectral}


def _port_trainer(state):
    gen = Generator(CFG, device="cpu", fused=False)
    gen.load_state_dict(weights.generator_state_dict(_gen_vars(state), JCFG), strict=True)
    mpd = MultiPeriodDiscriminator(CFG, CFG.disc_pair_batched, device="cpu")
    mpd.load_state_dict(weights.mpd_state_dict({"params": state.disc_params["mpd"]}, JCFG),
                        strict=True)
    msd = MultiScaleDiscriminator(CFG.disc_pair_batched, device="cpu")
    msd.load_state_dict(weights.msd_state_dict({"params": state.disc_params["msd"],
                                                "spectral": state.msd_spectral}), strict=True)
    return GANTrainer(CFG, device="cpu", generator=gen, mpd=mpd, msd=msd)


@pytest.fixture(scope="module")
def port_step(jax_step):
    trainer = _port_trainer(jax_step["state"])
    metrics = trainer.step(_batch(), noise=torch.tensor(jax_step["noise"]))
    return trainer, {k: float(v) for k, v in metrics.items()}


def _expected(jax_step, grads: bool):
    """JAX's gradients (``grads``) or new state in the port's key layout:
    {module name: {key: array}}."""
    if grads:
        g, d = jax_step["g_grads"], jax_step["d_grads"]
        gen = weights.generator_state_dict({"params": g}, JCFG)
    else:
        s = jax_step["new_state"]
        g, d = s.gen_params, s.disc_params
        gen = weights.generator_state_dict(_gen_vars(s), JCFG)
    msd_vars = {"params": d["msd"]}
    if not grads:
        msd_vars["spectral"] = jax_step["new_state"].msd_spectral
    return {"gen": gen, "mpd": weights.mpd_state_dict({"params": d["mpd"]}, JCFG),
            "msd": weights.msd_state_dict(msd_vars)}


def _modules(trainer):
    return {"gen": trainer.gen, "mpd": trainer.mpd, "msd": trainer.msd}


def test_gan_step_scalars(jax_step, port_step):
    """The four scalars: rtol 1e-5."""
    _, got = port_step
    for k in SCALAR_KEYS:
        want = float(jax_step["metrics"][k])
        print(f"{k}: port {got[k]:.7g}, JAX {want:.7g}")
        np.testing.assert_allclose(got[k], want, rtol=1e-5, err_msg=k)


def test_gan_step_gradients(jax_step, port_step):
    """The D step's gradients of both discriminators and the G step's of the
    Generator (the G step leaves the discriminators' alone): each within
    1e-4 of its tensor's largest gradient plus 1e-5 of its module's.  The
    second term holds the upsamplers' biases, whose gradient is 0 but for
    rounding: a batch-statistics BatchNorm follows them and removes any
    constant (up to 1.03 of their own tiny largest value, 1e-6 of the
    Generator's largest gradient, here)."""
    trainer, _ = port_step
    want = _expected(jax_step, grads=True)
    n, worst = 0, 0.0
    for name, module in _modules(trainer).items():
        params = dict(module.named_parameters())
        expected = {k: w for k, w in want[name].items() if not k.endswith("num_batches_tracked")}
        assert set(expected) == set(params), name
        module_max = max(float(w.abs().max()) for w in expected.values())
        for key, w in expected.items():
            got = params[key].grad
            assert got is not None, f"{name}.{key} has no gradient"
            err = float((got - w).abs().max())
            bound = 1e-4 * float(w.abs().max()) + 1e-5 * module_max
            worst = max(worst, err / bound)
            assert err <= bound, f"{name}.{key}: max |port - JAX| = {err:.3g}, bound {bound:.3g}"
            n += 1
    print(f"{n} gradients, worst max |port - JAX| at {worst:.3g} of its bound")


def test_gan_step_state(jax_step, port_step):
    """After the step: BatchNorm running statistics and every spectral u, v
    (the CBNs' once, the MSD's twice) at atol 1e-5; the parameters as the
    module docstring says."""
    trainer, _ = port_step
    want = _expected(jax_step, grads=False)
    grads = _expected(jax_step, grads=True)
    lr = CFG.learning_rate
    flipped = total = 0
    for name, module in _modules(trainer).items():
        got = module.state_dict()
        params = dict(module.named_parameters())
        assert set(got) == set(want[name]), name
        for key, w in want[name].items():
            if key.endswith("num_batches_tracked"):
                continue
            g = got[key]
            if key not in params:  # running statistics, spectral u and v
                torch.testing.assert_close(g, w, atol=1e-5, rtol=0, msg=f"{name}.{key}")
                continue
            g_port, g_jax = params[key].grad, grads[name][key]
            agree = (torch.sign(g_port) == torch.sign(g_jax)) & (g_jax.abs() > 1e-4)
            diff = (g - w).abs()
            assert not bool((diff[agree] > 1e-6).any()), f"{name}.{key}"
            assert float(diff.max()) <= 2 * lr + 1e-6, f"{name}.{key}"
            flipped += int((diff > 1e-6).sum())
            total += diff.numel()
    print(f"parameters: {flipped} of {total} entries differ past 1e-6 (gradients at rounding "
          f"level that flipped AdamW's sign step)")
    assert flipped <= 1e-3 * total


def test_gan_step_spectral_vectors_advance(jax_step, port_step):
    """The step moved the CBN and MSD vectors: compared with the state
    before the step, not only with JAX after it."""
    trainer, _ = port_step
    before = jax_step["state"]
    u0 = before.msd_spectral["discriminators_0"]["convs_0"]["u"]
    u1 = trainer.msd.discriminators[0].convs[0].weight_u.numpy()
    assert np.abs(u1 - u0).max() > 1e-6
    v0 = before.gen_spectral["cbns_0"]["layer"]["v"]
    assert np.abs(trainer.gen.cbns[0].layer.weight_v.numpy() - v0).max() > 1e-6


def test_device_mel_target_matches_host_path():
    """``device_mel_target``: the step computes the mel target from the batch
    audio, 0 past each item's frames.  On items that fill the batch (as the
    JAX package's test does) it gives the host path's losses and state
    (atol 1e-6): the in-step op is the host op's twin."""
    rng = np.random.default_rng(5)
    items = []
    for i in range(3):
        items.append({"wv_feat": rng.standard_normal((8, CFG.n_feat_dim)).astype(np.float32),
                      "spk_emb": rng.standard_normal(CFG.spk_dim).astype(np.float32),
                      "audio": (rng.standard_normal(8 * CFG.total_upsample) * 0.1
                                ).astype(np.float32),
                      "filename": f"u{i}"})
    host_items = [dict(it, mel_loss=mel_spectrogram_np(
        it["audio"], CFG.n_fft, CFG.num_mels, CFG.sampling_rate, CFG.hop_size, CFG.win_size,
        CFG.fmin, CFG.fmax_for_loss)) for it in items]
    host_batch = pad_vocoder_batch(host_items, CFG, frame_pad=8)
    dev_batch = pad_vocoder_batch(items, CFG, frame_pad=8)
    assert "mel_loss" not in dev_batch and dev_batch["mel_frames"].tolist() == [8, 8, 8]

    results = []
    for cfg, batch in ((CFG, host_batch),
                       (dataclasses.replace(CFG, device_mel_target=True), dev_batch)):
        torch.manual_seed(3)
        trainer = GANTrainer(cfg, device="cpu", seed=4)
        target = trainer.mel_target(trainer.to_device(batch))
        metrics = trainer.step(batch)
        results.append((target, {k: float(v) for k, v in metrics.items()},
                        trainer.gen.state_dict()))
    (t_host, m_host, s_host), (t_dev, m_dev, s_dev) = results
    torch.testing.assert_close(t_dev, t_host, atol=1e-5, rtol=0)
    for k in SCALAR_KEYS:
        np.testing.assert_allclose(m_dev[k], m_host[k], rtol=1e-6, err_msg=k)
    for k in s_host:
        torch.testing.assert_close(s_dev[k], s_host[k], atol=1e-6, rtol=0, msg=k)


def test_set_learning_rate_decays_per_epoch():
    """The loop's per-epoch lr0 * lr_decay ** epoch reaches both optimizers,
    and the next step uses it."""
    torch.manual_seed(0)
    trainer = GANTrainer(CFG, device="cpu")
    for epoch in range(3):
        lr = CFG.learning_rate * CFG.lr_decay ** epoch
        trainer.set_learning_rate(lr)
        for opt in (trainer.opt_g, trainer.opt_d):
            assert [g["lr"] for g in opt.param_groups] == [lr]
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=1.0)
    set_learning_rate(opt, 0.0)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
