"""The port's speaker embedders (``data/spk_emb.py``) and SpeechBrain's ECAPA
(``models/ecapa_speechbrain.py``) against the JAX package on the CPU: JAX's
seeded variables (BatchNorm statistics randomised) carried by
``weights.py``, the same waveforms.  Tolerance: atol 2e-4 (f32 on both
sides, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import _randomize_stats
from wavthruvec_pytorch_tpu.data import spk_emb as jspk
from wavthruvec_pytorch_tpu.models import ecapa_speechbrain as jsb
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.data import spk_emb
from wavthruvec_pytorch_tpu_torch.models import ecapa_speechbrain as sb


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _speaker_wavs(n, seed, lo=3000, hi=9000):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        L = int(rng.integers(lo, hi))
        t = np.arange(L) / 16000.0
        out.append((0.3 * np.sin(2 * np.pi * rng.uniform(90, 250) * t)
                    + 0.03 * rng.standard_normal(L)).astype(np.float32))
    return out


def _sb_fbank_f64(wav):
    """SpeechBrain's fbank in float64 (the angles reduced exactly): the
    reference both packages' f32 fbanks are held to."""
    x = torch.nn.functional.pad(torch.tensor(wav, dtype=torch.float64), (200, 200))
    k = torch.arange(201, dtype=torch.float64)[:, None]
    t = torch.arange(400, dtype=torch.float64)[None]
    ang = 2 * np.pi * ((k * t) % 400) / 400
    win = 0.54 - 0.46 * torch.cos(2 * np.pi * t / 400)
    spec = torch.nn.functional.conv1d(
        x[:, None], torch.cat([torch.cos(ang) * win, -torch.sin(ang) * win])[:, None], stride=160)
    power = spec[:, :201] ** 2 + spec[:, 201:] ** 2
    mel = torch.einsum("fm,bft->btm", torch.tensor(sb._sb_mel_filterbank(), dtype=torch.float64),
                       power)
    db = 10 * torch.log10(mel.clamp(min=1e-10))
    return torch.maximum(db, db.max() - 80).numpy()


def test_sb_fbank():
    """SpeechBrain's fbank == JAX's: atol 2e-4 dB in the bands within 40 dB
    of the batch's peak.  Further down, f32 cancellation in the DFT's sums
    moves both packages by ~2e-3 dB from the float64 fbank: there the port
    must lie no farther from it than JAX does, plus 2e-4 dB.  Sentence
    normalisation: atol 2e-4 on the port's own fbank.  The filterbank is
    equal."""
    wav = np.concatenate(_speaker_wavs(2, 0))[None].repeat(2, 0)
    wav[1] *= 0.1
    want = np.asarray(jsb.sb_fbank(jnp.asarray(wav)))
    got = sb.sb_fbank(torch.tensor(wav)).numpy()
    assert got.shape == want.shape
    loud = want > want.max() - 40
    assert loud.mean() > 0.4
    np.testing.assert_allclose(got[loud], want[loud], atol=2e-4)
    ref = _sb_fbank_f64(wav)
    assert np.abs(got - ref).max() <= np.abs(want - ref).max() + 2e-4
    np.testing.assert_allclose(sb.sentence_norm(torch.tensor(want)).numpy(),
                               np.asarray(jsb.sentence_norm(jnp.asarray(want))), atol=2e-4)
    np.testing.assert_array_equal(sb._sb_mel_filterbank(), jsb._sb_mel_filterbank())


def _with_stats(variables, seed):
    v = dict(_np(variables))
    v["batch_stats"] = _randomize_stats(v["batch_stats"], seed)
    return v


def test_speaker_embedder():
    """``SpeakerEmbedder`` (ECAPA on raw wav, C = 64) == JAX's on a speaker's
    concatenated utterances, padded to the same power-of-two bucket."""
    wavs = _speaker_wavs(4, 1)
    jemb = jspk.SpeakerEmbedder(C=64)
    jemb.variables = _with_stats(jemb.variables, 2)
    sd = weights._to_torch(weights._export({c: {"m": t} for c, t in jemb.variables.items()},
                                           weights._ecapa_spec("m", "m")))
    temb = spk_emb.SpeakerEmbedder({k[2:]: v for k, v in sd.items()}, C=64, device="cpu")
    assert len(temb.padded(wavs)) == 32768
    np.testing.assert_allclose(temb.embed_concat(wavs), jemb.embed_concat(wavs), atol=2e-4)


@pytest.fixture(scope="module")
def sb_pair():
    """JAX's SpeechBrainEmbedder at the published widths and the port's with
    its variables."""
    jemb = jspk.SpeechBrainEmbedder()
    jemb.variables = _with_stats(jemb.variables, 3)
    temb = spk_emb.SpeechBrainEmbedder(state_dict=weights.speechbrain_state_dict(jemb.variables),
                                       device="cpu")
    return jemb, temb


@pytest.mark.parametrize("exact", [False, True], ids=["whole_seconds", "exact"])
def test_speechbrain_embedder(sb_pair, exact):
    """``SpeechBrainEmbedder`` at SpeechBrain's published widths == JAX's, cut
    to whole seconds or kept exact."""
    jemb, temb = sb_pair
    wavs = _speaker_wavs(3, 4)
    n = len(temb.trimmed(wavs, exact))
    assert n == (sum(map(len, wavs)) if exact else 16000 * (sum(map(len, wavs)) // 16000))
    np.testing.assert_allclose(temb.embed_concat(wavs, exact=exact),
                               jemb.embed_concat(wavs, exact=exact), atol=2e-4)


def test_speechbrain_checkpoint_keys(sb_pair, tmp_path):
    """An ``embedding_model.ckpt`` with SpeechBrain's keys (here: the carried
    state dict under an ``embedding_model.`` prefix) loads strictly, and the
    JAX package's importer reads the same file into the same variables."""
    from wavthruvec_pytorch_tpu.checkpoint import import_speechbrain_ecapa

    jemb, temb = sb_pair
    sd = temb.model.state_dict()
    torch.save({"embedding_model." + k: v for k, v in sd.items()}, tmp_path / "emb.ckpt")
    loaded = spk_emb.SpeechBrainEmbedder(torch_ckpt=str(tmp_path / "emb.ckpt"), device="cpu")
    for k, v in sd.items():
        assert torch.equal(loaded.model.state_dict()[k], v), k
    back = import_speechbrain_ecapa({k: v.numpy() for k, v in sd.items()})
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(
                                  {c: jemb.variables[c] for c in back})[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


def test_precompute_writes_one_file_a_speaker(tmp_path):
    """``precompute_speaker_embeddings`` over a two-speaker tree: one
    ``{spk}.npy`` of [192] per speaker, equal to the embedder's output."""
    from scipy.io import wavfile

    from wavthruvec_pytorch_tpu_torch.data.vocoder_data import load_wav

    for s, spk in enumerate(("SSB0001", "SSB0002")):
        (tmp_path / "wav" / spk).mkdir(parents=True)
        for i, w in enumerate(_speaker_wavs(3, 10 + s)):
            wavfile.write(tmp_path / "wav" / spk / f"u{i}.wav", 16000, (w * 20000).astype(np.int16))
    emb = spk_emb.SpeakerEmbedder(C=64, device="cpu")
    out = spk_emb.precompute_speaker_embeddings(str(tmp_path / "wav"), str(tmp_path / "emb"), emb)
    assert sorted(out) == ["SSB0001", "SSB0002"]
    for spk, e in out.items():
        saved = np.load(tmp_path / "emb" / f"{spk}.npy")
        assert saved.shape == (192,) and np.array_equal(saved, e)
        wavs = [load_wav(str(tmp_path / "wav" / spk / f"u{i}.wav"))[0] for i in range(3)]
        np.testing.assert_array_equal(e, emb.embed_concat(wavs))
