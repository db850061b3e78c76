"""ECAPA's raw-wav path in the port against the JAX package on the CPU: the
fbank front end, its SpecAugment given the same bands, ECAPA_TDNN with
``input_wav=True`` and Text2Vec with ``input_wav=True`` (inference, and the
training forward with MAS).  The same numpy inputs go through both
packages; JAX weights are carried into the port by ``weights.py``.

The Text2Vec cases reuse ``tests/test_torch_train.py``'s config (the JAX
BiGRU takes the Pallas forward in interpret mode, dropout 0) and its B = 8
(at B = 2 ECAPA's last BatchNorms leave the result to f32 rounding).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import JCFG, _init_params, _items, _randomize_stats
from wavthruvec_pytorch_tpu.models import ecapa as jecapa
from wavthruvec_pytorch_tpu.models import losses as jlosses
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.ops.mas import mas_width1_batched
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, check_ported
from wavthruvec_pytorch_tpu_torch.models import ecapa
from wavthruvec_pytorch_tpu_torch.models import losses as tlosses
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import make_padded_batch

JCFG_WAV = dataclasses.replace(JCFG, input_wav=True)
CFG_WAV = Text2VecConfig(**{f.name: getattr(JCFG_WAV, f.name)
                            for f in dataclasses.fields(Text2VecConfig)})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wavs(B, L, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    f0 = rng.uniform(100, 300, (B, 1))
    return (0.3 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal((B, L))).astype(
        np.float32)


def test_wav_to_fbank():
    """The log-mel front end == JAX's ``wav_to_fbank``: atol 1e-4 (the same
    f32 DFT basis, sums in another order)."""
    wav = _wavs(3, 8000 + 37, 0)
    want = np.asarray(jecapa.wav_to_fbank(jnp.asarray(wav)))
    got = ecapa.wav_to_fbank(torch.tensor(wav)).numpy()
    assert got.shape == want.shape == (3, (8000 + 37) // 160 + 1, 80)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_array_equal(ecapa._htk_mel_filterbank(16000, 512, 80, 20.0, 7600.0),
                                  jecapa._htk_mel_filterbank(16000, 512, 80, 20.0, 7600.0))


def _jax_bands(rng, x, freq_mask_width=(0, 8), time_mask_width=(0, 10)):
    """The bands JAX's ``fbank_aug`` draws from ``rng`` (its draws, in its
    order), as ``draw_bands`` returns them."""
    B = x.shape[0]
    out = {}
    r_time, r_freq = jax.random.split(rng)
    for name, key, D, width_range in (("time", r_time, x.shape[1], time_mask_width),
                                      ("freq", r_freq, x.shape[2], freq_mask_width)):
        k_len, k_pos = jax.random.split(key)
        width = jax.random.randint(k_len, (B, 1), width_range[0], width_range[1])
        high = jnp.maximum(1, D - jnp.max(width))
        start = jax.random.randint(k_pos, (B, 1), 0, high)
        out[name] = (torch.tensor(np.asarray(width), dtype=torch.int64),
                     torch.tensor(np.asarray(start), dtype=torch.int64))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fbank_aug_given_the_same_bands(seed):
    """``mask_bands`` with JAX's bands == JAX's ``fbank_aug``, exactly; the
    port's own draw keeps every band inside its axis."""
    x = np.random.default_rng(seed).standard_normal((4, 30, 80)).astype(np.float32)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jecapa.fbank_aug(rng, jnp.asarray(x)))
    got = ecapa.mask_bands(torch.tensor(x), _jax_bands(rng, x)).numpy()
    np.testing.assert_array_equal(got, want)
    bands = ecapa.draw_bands(4, 30, 80, torch.Generator().manual_seed(seed))
    for name, D, hi in (("time", 30, 10), ("freq", 80, 8)):
        width, start = bands[name]
        assert ((0 <= width) & (width < hi)).all() and ((start + width) <= D).all()
    aug = ecapa.fbank_aug(torch.tensor(x), torch.Generator().manual_seed(seed))
    assert torch.equal(aug, ecapa.mask_bands(torch.tensor(x), bands))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "batch_stats"])
def test_ecapa_input_wav(train):
    """``ECAPA_TDNN(input_wav=True)`` == JAX's on raw waveforms: conv1 takes 80
    mel channels whatever ``n_feat_dim`` says; atol 2e-4, in eval mode and on
    batch statistics (with the running statistics it leaves), at B = 8."""
    wav = _wavs(8, 9600, 1)
    jm = jecapa.ECAPA_TDNN(C=64, n_feat_dim=1024, n_speaker_dim=16, input_wav=True)
    jv = _np(jm.init(jax.random.PRNGKey(3), jnp.asarray(wav)))
    jv["batch_stats"] = _randomize_stats(jv["batch_stats"], 4)
    assert jv["params"]["conv1"]["Conv_0"]["kernel"].shape == (5, 80, 64)
    out = jm.apply(jv, jnp.asarray(wav), train=train, mutable=["batch_stats"] if train else False)
    want, jstats = (out if train else (out, None))
    sd = weights._to_torch(weights._export({c: {"m": t} for c, t in jv.items()},
                                           weights._ecapa_spec("m", "m")))
    tm = ecapa.ECAPA_TDNN(64, 1024, 16, input_wav=True, device="cpu")
    tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.tensor(wav)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
    if train:
        new = weights._export({"params": {"m": jv["params"]},
                               "batch_stats": {"m": _np(jstats["batch_stats"])}},
                              weights._ecapa_spec("m", "m"))
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), new["m." + k], rtol=1e-4, atol=1e-5,
                                           err_msg=k)


def _jax_forward_ref_wav(m, src_seq, src_pos, wav_feat, in_lens, out_lens, WVF_pos,
                         attn_prior, ref_wav):
    """JAX's training branch (``Text2Vec.__call__``, text2vec.py:182-248,
    MAS on, BatchNorm on batch statistics, dropout off) with ECAPA fed the
    reference waveforms: ``__call__`` hands ECAPA the target features."""
    enc, _, _, _ = m.encoder(src_seq, src_pos, ref_wav, deterministic=True, train=True)
    attn_soft, attn_logprob = m.attention(wav_feat, enc, key_lens=in_lens, attn_prior=attn_prior)
    attn_hard = mas_width1_batched(jax.lax.stop_gradient(attn_soft), in_lens, out_lens)
    duration = jnp.sum(attn_hard, axis=1).astype(jnp.int32)
    lr_output = jnp.einsum("btn,bnc->btc", attn_hard, enc)
    dp = m.duration_predictor(enc, deterministic=True)
    T = wav_feat.shape[1]
    wvf = m.mask_tensor(m.WVF_linear(m.decoder(lr_output, WVF_pos, deterministic=True)),
                        WVF_pos, T)
    post = m.mask_tensor(wvf + m.last_linear(m.postnet(wvf, train=True)), WVF_pos, T)
    return {"feat_output": wvf, "feat_postnet_output": post, "duration_predictor_output": dp,
            "duration": duration, "attn": attn_hard, "attn_soft": attn_soft}


# (text, frames) of the batch; the reference waveforms are 0.3-0.5 s
WAV_LENGTHS = [(12, 64), (9, 60), (5, 57), (7, 50), (16, 64), (10, 62), (8, 40), (11, 58)]


@pytest.fixture(scope="module")
def wav_model():
    batch = make_padded_batch(_items(CFG_WAV, WAV_LENGTHS, seed=9), CFG_WAV)
    ref_wav = _wavs(8, 6400, 2)
    model = JText2Vec(JCFG_WAV)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos", "attn_prior"))
    shapes = jax.eval_shape(lambda key: model.init({"params": key}, *args, jnp.asarray(ref_wav),
                                                   method=_jax_forward_ref_wav),
                            jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 10)
    stats = _randomize_stats(shapes["batch_stats"], 10)
    assert params["encoder"]["speaker_encoder"]["conv1"]["Conv_0"]["kernel"].shape[1] == 80
    port = Text2Vec(CFG_WAV, device="cpu")
    port.load_state_dict(weights.text2vec_state_dict({"params": params, "batch_stats": stats},
                                                     JCFG_WAV), strict=True)
    return dict(model=model, params=params, stats=stats, port=port, batch=batch, jb=jb,
                args=args, ref_wav=ref_wav)


def test_text2vec_input_wav_builds():
    """``input_wav=True`` passes ``check_ported``; the speaker encoder's conv1
    takes 80 mel channels; the training forward asks for the waveforms."""
    check_ported(CFG_WAV)
    model = Text2Vec(CFG_WAV, device="cpu")
    assert model.encoder.speaker_encoder.conv1.weight.shape[1] == ecapa.N_MELS
    with pytest.raises(ValueError, match="ref_wav"):
        model(*(torch.zeros(1, 4, dtype=torch.long),) * 2, torch.zeros(1, 8, CFG_WAV.n_feat_dim),
              torch.tensor([4]), torch.tensor([8]), torch.zeros(1, 8, dtype=torch.long))


def test_text2vec_input_wav_infer(wav_model):
    """``infer`` with raw reference waveforms == JAX's ``infer``: durations
    and frame counts exact, outputs atol 1e-3 (the BiGRU's bf16 w_hh)."""
    w = wav_model
    seq, pos = w["batch"]["text"][:4], w["batch"]["src_pos"][:4]
    ref = w["ref_wav"][:4]
    want = _np(w["model"].apply({"params": w["params"], "batch_stats": w["stats"]},
                                jnp.asarray(seq), jnp.asarray(pos), jnp.asarray(ref), 96,
                                method=JText2Vec.infer))
    got = w["port"].infer(torch.tensor(seq).long(), torch.tensor(pos).long(), torch.tensor(ref),
                          96)
    np.testing.assert_array_equal(got["durations"].numpy(), want["durations"])
    np.testing.assert_array_equal(got["total_frames"].numpy(), want["total_frames"])
    for k in ("feat_output", "feat_postnet_output"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-3, err_msg=k)


def test_text2vec_input_wav_training_forward(wav_model):
    """The training forward with a raw-wav reference (B = 8) == JAX's branch
    with ECAPA on the waveforms: hard alignments and durations exact, the
    losses rtol 1e-4."""
    w = wav_model
    out, mut = w["model"].apply({"params": w["params"], "batch_stats": w["stats"]}, *w["args"],
                                jnp.asarray(w["ref_wav"]), method=_jax_forward_ref_wav,
                                mutable=["batch_stats"])
    jb = w["jb"]
    jw, jp, jd = jlosses.dnn_loss(out["feat_output"], out["feat_postnet_output"],
                                  jb["feat_target"], out["duration_predictor_output"],
                                  out["duration"])
    jbin = jlosses.attention_binarization_loss(out["attn"], out["attn_soft"])
    port = copy.deepcopy(w["port"]).train()
    for m in port.modules():  # dropout 0 in the config; the BatchNorms on batch statistics
        assert not isinstance(m, torch.nn.Dropout) or m.p == 0.0
    b = {k: torch.tensor(v) for k, v in w["batch"].items() if isinstance(v, np.ndarray)}
    with torch.no_grad():
        got = port(b["text"].long(), b["src_pos"].long(), b["feat_target"],
                   b["input_lengths"].long(), b["output_lengths"].long(), b["feat_pos"].long(),
                   attn_prior=b["attn_prior"], ref_wav=torch.tensor(w["ref_wav"]))
    np.testing.assert_array_equal(got["attn"].numpy(), np.asarray(out["attn"]))
    np.testing.assert_array_equal(got["duration"].numpy(), np.asarray(out["duration"]))
    tw, tp, td = tlosses.dnn_loss(got["feat_output"], got["feat_postnet_output"],
                                  b["feat_target"], got["duration_predictor_output"],
                                  got["duration"])
    tbin = tlosses.attention_binarization_loss(got["attn"], got["attn_soft"])
    for name, a, ref in (("feat", tw, jw), ("postnet", tp, jp), ("duration", td, jd),
                         ("bin", tbin, jbin)):
        np.testing.assert_allclose(float(a), float(ref), rtol=1e-4, err_msg=name)
