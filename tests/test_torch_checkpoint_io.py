"""The port's training checkpoints on the CPU: the torch reference's files
(``checkpoint_{step}.pth.tar``; ``g_``/``do_``), written and read back by
the port, and read by the JAX package's importers.

* Round trips are bit-equal: model weights and buffers (BatchNorm
  statistics, every spectral norm's ``u``/``v``), the LAMB and AdamW
  moments, the step count.
* A run saved after k steps and resumed takes step k + 1 bit for bit as the
  unbroken run does (dropout 0; the GAN's noise given).
* The files load through the JAX package's ``import_text2vec``,
  ``import_vec2wav_generator``, ``import_vec2wav_mpd`` and
  ``import_vec2wav_msd``: the discriminators' variables map back to the
  files' tensors bit for bit, and JAX computes the port's outputs: the
  Generator atol 2e-4 (f32 both sides, sums in another order); Text2Vec
  inference at ``tests/test_torch_synthesize.py``'s
  tolerance, durations exact (the inputs keep every ``dp + 0.5`` at least
  1e-4 from an integer, asserted) and latents atol 1e-3 (the f32 sums
  around the BiGRU's bf16 rounding run in another order).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavthruvec_pytorch_tpu import checkpoint as jckpt
from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.models import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.models import vec2wav as jv
from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.data.prior import beta_binomial_prior_distribution
from wavthruvec_pytorch_tpu_torch.models import vec2wav as tv
from wavthruvec_pytorch_tpu_torch.ops.stft import mel_spectrogram
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer, make_padded_batch
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

# n_feat_dim 128 and gru_impl "pallas": the JAX BiGRU then computes what the
# port's computes (tests/test_torch_synthesize.py)
T2V = dict(n_feat_dim=128, spk_channel=32, n_speaker_dim=16, vocab_size=50,
           max_seq_len=64, encoder_dim=24, encoder_n_layer=2,
           encoder_conv1d_filter_size=48, decoder_dim=24, decoder_n_layer=2,
           decoder_conv1d_filter_size=48, duration_predictor_filter_size=16,
           gru_impl="pallas", text_buckets=(16,), frame_buckets=(64,), dropout=0.0,
           grad_clip_every=2, learning_rate=0.01)
V2W = dict(n_feat_dim=24, num_wv_feat=24, spk_dim=8, noise_dim=8,
           upsample_initial_channel=32, upsample_rates=(4, 4),
           upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 5),
           resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3))
GAN_T = 32  # latent frames: 512 samples, past the mel's reflect pad of 384
DP_BIAS = 3.0
MARGIN = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread in this module, the thread count restored
    after it.  These tests run thousands of small ops through the
    full-width discriminators; beside the other workers of a parallel test
    run, OpenMP's fork and join on every op costs far more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t2v_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    items = []
    for n, t in ((12, 64), (9, 50), (14, 61), (6, 40)):
        items.append({"text_enc": rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                      "feat_gt_target": (rng.standard_normal((t, cfg.n_feat_dim)) * 0.5
                                         ).astype(np.float32),
                      "attn_prior": beta_binomial_prior_distribution(n, t).astype(np.float32)})
    return make_padded_batch(items, cfg)


def _gan_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, GAN_T * cfg.total_upsample, 1)) * 0.1).astype(np.float32)
    mel = mel_spectrogram(torch.from_numpy(audio[..., 0]), cfg.n_fft, cfg.num_mels,
                          cfg.sampling_rate, cfg.hop_size, cfg.win_size, cfg.fmin,
                          cfg.fmax_for_loss).transpose(1, 2).numpy()
    return {"wv_feat": rng.standard_normal((2, GAN_T, cfg.n_feat_dim)).astype(np.float32),
            "spk_emb": rng.standard_normal((2, cfg.spk_dim)).astype(np.float32),
            "audio": audio, "mel_loss": mel}


def _noise(cfg, i):
    return torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
        (2, cfg.noise_dim)).astype(np.float32))


def _t2v_trainer(seed):
    torch.manual_seed(seed)
    return Text2VecTrainer(Text2VecConfig(**T2V), device="cpu")


def _gan_trainer(seed):
    torch.manual_seed(seed)
    return GANTrainer(Vec2WavConfig(**V2W), device="cpu", seed=seed)


def _equal(a, b) -> bool:
    """Nested state dicts: the same keys, bit-equal tensors, equal values."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Both trainers saved as the reference's files after k steps (3 for
    Text2Vec, 1 for the GAN), the state at the save kept, then one more
    step each: the unbroken runs the resume tests compare with."""
    tmp = tmp_path_factory.mktemp("ckpt")
    t2v = _t2v_trainer(0)
    batches = [_t2v_batch(t2v.cfg, s) for s in (1, 2, 3, 4)]
    for b in batches[:3]:
        t2v.step(b)
    t2v_file = ckpt.text2vec_path(str(tmp), t2v.step_count)
    ckpt.save_text2vec(t2v_file, t2v, epoch=2)
    t2v_at_save = copy.deepcopy(t2v.state_dict())
    t2v.step(batches[3])  # the 4th step clips (grad_clip_every 2)

    gan = _gan_trainer(0)
    msd_u0 = {k: v.clone() for k, v in gan.msd.state_dict().items() if k.endswith("weight_u")}
    gbatch = _gan_batch(gan.cfg, 2)
    gan.step(gbatch, noise=_noise(gan.cfg, 0))
    ckpt.save_vec2wav(str(tmp), gan.step_count - 1, gan, epoch=1)
    gan_at_save = copy.deepcopy(gan.state_dict())
    gan.step(gbatch, noise=_noise(gan.cfg, 1))
    return dict(tmp=str(tmp), t2v=t2v, t2v_file=t2v_file, t2v_at_save=t2v_at_save,
                t2v_batch=batches[3], gan=gan, gan_at_save=gan_at_save, gan_batch=gbatch,
                msd_u0=msd_u0)


def test_text2vec_round_trip_bit_equal(saved):
    """checkpoint_3.pth.tar holds the reference's keys; loaded into a trainer
    built from another seed, its model (BatchNorm statistics included),
    LAMB's moments, lr and step count equal the saved trainer's."""
    obj = torch.load(saved["t2v_file"], map_location="cpu", weights_only=False)
    assert set(obj) == {"model", "optimizer", "learning_rate", "epoch"}
    assert obj["epoch"] == 2 and obj["learning_rate"] == T2V["learning_rate"]
    got = _t2v_trainer(5)
    assert ckpt.load_text2vec(saved["t2v_file"], got) == 2
    want = saved["t2v_at_save"]
    have = got.state_dict()
    assert have["step_count"] == 3
    assert _equal(have["model"], want["model"])
    assert _equal(have["optimizer"], want["optimizer"])
    moments = have["optimizer"]["state"]
    # every parameter with a gradient (all but the dead postnet.pre_highway)
    assert len(moments) == sum(p.grad is not None for p in saved["t2v"].params)
    assert all(set(m) == {"exp_avg", "exp_avg_sq"} for m in moments.values())
    assert sum(bool(m["exp_avg_sq"].any()) for m in moments.values()) > len(moments) // 2
    assert any(k.endswith("running_mean") for k in have["model"])


def test_gan_round_trip_bit_equal(saved):
    """g_00000000 and do_00000000 hold the reference's keys; loaded into a
    trainer built from another seed, the three modules (the spectral norms'
    ``u``/``v``, moved by the step; the CBNs' statistics), both AdamW states
    and the step count equal the saved trainer's, and the next step is
    numbered 1."""
    g_file, do_file = ckpt.latest_vec2wav(saved["tmp"])
    assert os.path.basename(g_file) == "g_00000000"
    do = torch.load(do_file, map_location="cpu", weights_only=False)
    assert set(do) == {"mpd", "msd", "optim_g", "optim_d", "steps", "epoch"}
    assert do["steps"] == 0 and do["epoch"] == 1
    got = _gan_trainer(7)
    assert ckpt.load_vec2wav(g_file, do_file, got) == {"steps": 1, "epoch": 1}
    want = saved["gan_at_save"]
    have = got.state_dict()
    assert have["step_count"] == 1
    for key in ("generator", "mpd", "msd", "optim_g", "optim_d"):
        assert _equal(have[key], want[key]), key
    u0 = saved["msd_u0"]
    assert u0 and not all(torch.equal(have["msd"][k], u0[k]) for k in u0)
    for opt in ("optim_g", "optim_d"):
        assert all(set(m) >= {"exp_avg", "exp_avg_sq"} for m in have[opt]["state"].values())


@pytest.mark.parametrize("name,step", [
    ("checkpoint_12.pth.tar", 12), ("checkpoint_1200.pth.tar", 1200), ("g_00000012", 12),
    ("do_00000003", 3), ("checkpoint_12.pth.tar.tmp", -1), ("g_00000012.tmp", -1),
    ("model_new", -1)])
def test_checkpoint_step(name, step):
    assert ckpt.checkpoint_step(os.path.join("run", name)) == step


@pytest.mark.parametrize("prefix,names,want", [
    ("checkpoint_", ["checkpoint_2.pth.tar", "checkpoint_10.pth.tar",
                     "checkpoint_12.pth.tar.tmp"], "checkpoint_10.pth.tar"),
    ("do_", ["do_00000002", "do_00000011", "do_00000013.tmp", "g_00000014"], "do_00000011"),
    ("g_", [], None)])
def test_scan_checkpoint_picks_highest_step(tmp_path, prefix, names, want):
    """The highest step by number, not by name; a temporary file of a save
    in progress is never taken."""
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = ckpt.scan_checkpoint(str(tmp_path), prefix)
    assert got == (None if want is None else str(tmp_path / want))


def test_save_leaves_no_temporary_file(tmp_path):
    trainer = _t2v_trainer(0)
    ckpt.save_text2vec(ckpt.text2vec_path(str(tmp_path), 4), trainer, 0)
    assert os.listdir(tmp_path) == ["checkpoint_4.pth.tar"]


def test_text2vec_resume_equals_unbroken(saved):
    """3 steps, save, load into a trainer of another seed, 1 step == 4
    unbroken steps, bit for bit: weights, BatchNorm statistics, LAMB state.
    ``grad_clip_every`` is 2, so the resumed step count sets whether the
    fourth step clips (it does)."""
    resumed = _t2v_trainer(9)
    ckpt.load_text2vec(saved["t2v_file"], resumed)
    resumed.step(saved["t2v_batch"])
    assert _equal(resumed.state_dict(), saved["t2v"].state_dict())


def test_gan_resume_equals_unbroken(saved):
    """1 step, save, load into a trainer of another seed, 1 step == 2
    unbroken steps, bit for bit (the same noise given to each step): every
    module's state, spectral vectors included, and both AdamW states."""
    resumed = _gan_trainer(9)
    ckpt.load_vec2wav(*ckpt.latest_vec2wav(saved["tmp"]), resumed)
    resumed.step(saved["gan_batch"], noise=_noise(resumed.cfg, 1))
    assert _equal(resumed.state_dict(), saved["gan"].state_dict())


# --- back into the JAX package ------------------------------------------------

def test_gan_files_import_into_jax(saved):
    """g_ and do_ through import_vec2wav_generator, _mpd and _msd: JAX's
    Generator (eval mode) computes the saved Generator's waveform, atol
    2e-4; the imported MPD and MSD variables (the MSD's spectral vectors
    too) map back through ``weights`` to the files' tensors bit for bit."""
    g_file, do_file = ckpt.latest_vec2wav(saved["tmp"])
    jcfg = JV2W(**V2W)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, jcfg.n_feat_dim)).astype(np.float32)
    spk = rng.standard_normal((2, jcfg.spk_dim)).astype(np.float32)
    z = rng.standard_normal((2, jcfg.noise_dim)).astype(np.float32)
    gen_vars = jckpt.import_vec2wav_generator(jckpt.load_torch_state_dict(g_file, "generator"),
                                              jcfg)
    want = jv.Generator(jcfg, fused=False).apply(gen_vars, *(jnp.asarray(a) for a in (x, spk, z)),
                                                 train=False)
    gen = tv.Generator(Vec2WavConfig(**V2W), device="cpu", fused=False)
    gen.load_state_dict(saved["gan_at_save"]["generator"], strict=True)
    with torch.no_grad():
        got = gen.eval()(*(torch.from_numpy(a) for a in (x, spk, z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)

    do = torch.load(do_file, map_location="cpu", weights_only=False)
    mpd = jckpt.import_vec2wav_mpd(jckpt.load_torch_state_dict(do_file, "mpd"), jcfg)
    msd = jckpt.import_vec2wav_msd(jckpt.load_torch_state_dict(do_file, "msd"))
    assert _equal(weights.mpd_state_dict(jax.tree_util.tree_map(np.asarray, mpd), jcfg),
                  do["mpd"])
    assert _equal(weights.msd_state_dict(jax.tree_util.tree_map(np.asarray, msd)), do["msd"])


def test_text2vec_file_imports_into_jax(saved, tmp_path):
    """checkpoint_{step}.pth.tar through import_text2vec: JAX
    ``Text2Vec.infer`` computes the trained port model's durations exactly
    and its latents within atol 1e-3.  The duration predictor's output bias
    is raised by 3 before the save, so that the model speaks several frames
    a token."""
    t2v = saved["t2v"]
    model = t2v.model
    with torch.no_grad():
        model.length_regulator.duration_predictor.linear_layer.linear_layer.bias.add_(DP_BIAS)
    try:
        path = ckpt.text2vec_path(str(tmp_path), t2v.step_count)
        ckpt.save_text2vec(path, t2v, 0)
        rng = np.random.default_rng(12)
        src_seq = np.zeros((2, 8), np.int64)
        src_seq[0, :8] = rng.integers(3, 50, 8)
        src_seq[1, :5] = rng.integers(3, 50, 5)
        src_pos = np.where(src_seq != 0, np.arange(1, 9)[None], 0)
        ref = (rng.standard_normal((2, 19, 128)) * 0.5).astype(np.float32)
        got = model.infer(*(torch.from_numpy(a) for a in (src_seq, src_pos, ref)), 32, 1.0)
    finally:
        with torch.no_grad():
            model.length_regulator.duration_predictor.linear_layer.linear_layer.bias.sub_(DP_BIAS)
    jcfg = JT2V(**T2V)
    variables = jckpt.import_text2vec(jckpt.load_torch_state_dict(path, "model"), jcfg)
    want = jax.jit(lambda v, a, b, c: JText2Vec(jcfg).apply(v, a, b, c, 32, 1.0,
                                                            method=JText2Vec.infer))(
        variables, jnp.asarray(src_seq), jnp.asarray(src_pos), jnp.asarray(ref))
    v = (np.asarray(want["duration_predictor_output"], np.float64) + 0.5)
    assert np.abs(v - np.round(v))[src_seq != 0].min() >= MARGIN
    np.testing.assert_array_equal(got["durations"].numpy(), np.asarray(want["durations"]))
    assert got["total_frames"].min() > 0
    np.testing.assert_allclose(got["feat_postnet_output"].numpy(),
                               np.asarray(want["feat_postnet_output"]), atol=1e-3)
    print(f"latents max |port - JAX| "
          f"{np.abs(got['feat_postnet_output'].numpy() - want['feat_postnet_output']).max():.3g}")
