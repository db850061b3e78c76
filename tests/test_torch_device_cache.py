"""The device-resident corpora of the port (``data/device_cache.py``,
``data/vocoder_device_cache.py``) against the port's host collate and the
JAX package's caches, on the CPU (``device="cpu"``), on small on-disk
corpora built as ``tests/test_data_pipeline.py`` builds them.

Tolerance: none.  A staged batch is a gather of the staged values, zeroed
past each item's lengths: it equals the host collate's batch (moved as
``batch_to_device`` moves it) and JAX's staged batch bit for bit,
and the window starts and batch orders are the same numpy streams.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.test_models import T2V_SMALL, V2W_SMALL
from wavthruvec_pytorch_tpu.data.dataset import BucketedLoader as JBucketedLoader
from wavthruvec_pytorch_tpu.data.dataset import load_buffer as jax_load_buffer
from wavthruvec_pytorch_tpu.data.device_cache import DeviceResidentData as JDeviceResidentData
from wavthruvec_pytorch_tpu.data.vocoder_data import VocoderDataset as JVocoderDataset
from wavthruvec_pytorch_tpu.data.vocoder_data import VocoderLoader as JVocoderLoader
from wavthruvec_pytorch_tpu.data.vocoder_device_cache import (
    VocoderDeviceData as JVocoderDeviceData,
)
from wavthruvec_pytorch_tpu.text import TextFrontend as JTextFrontend
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.data import device_cache
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader, load_buffer
from wavthruvec_pytorch_tpu_torch.data.device_cache import DeviceResidentData
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import (
    VocoderDataset,
    VocoderLoader,
    get_dataset_filelist,
)
from wavthruvec_pytorch_tpu_torch.data.vocoder_device_cache import VocoderDeviceData
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import BATCH_KEYS, batch_to_device

SYMS = "PE abcdefg"
TEXTS = ["abc", "defg", "aceg", "bdf", "abcdefg", "gfe", "ab", "cde"]


def _port(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


# --- Text2Vec --------------------------------------------------------------------

@pytest.fixture(scope="module")
def t2v_corpus(tmp_path_factory):
    """8 items of 10-29 frames, text buckets (8, 16), frame buckets (16, 32):
    the buffers of both packages and the port's config."""
    root = tmp_path_factory.mktemp("t2v")
    jcfg = dataclasses.replace(T2V_SMALL, vocab_size=len(SYMS),
                               betabinom_cache_path=str(root / "align_prior"),
                               feat_ground_truth=str(root / "w2v_feat"), batch_size=2,
                               batch_expand_size=2, text_buckets=(8, 16), frame_buckets=(16, 32))
    rng = np.random.default_rng(0)
    (root / "w2v_feat" / "SSB001").mkdir(parents=True)
    lines = []
    for i, text in enumerate(TEXTS):
        t = int(rng.integers(10, 30))
        np.save(root / "w2v_feat" / "SSB001" / f"u{i}.npy",
                rng.standard_normal((1, t, jcfg.n_feat_dim)).astype(np.float32))
        lines.append(f"SSB001/u{i}.npy|{text}|SSB001")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    cfg = _port(Text2VecConfig, jcfg)
    buffer = load_buffer([str(root / "train.txt")], cfg, TextFrontend(SYMS))
    jbuffer = jax_load_buffer([str(root / "train.txt")], jcfg, JTextFrontend(SYMS))
    return cfg, jcfg, buffer, jbuffer


@pytest.mark.parametrize("shuffle", [True, False], ids=["per_bucket", "per_bucket_in_order"])
def test_device_resident_data_matches_host_collate_and_jax(t2v_corpus, shuffle):
    """Batch for batch over an epoch, shuffled (the training loader's) and
    in the buffer's order (the validation loader's): the staged batch
    equals the port's host collate and JAX's ``DeviceResidentData``,
    exactly; the epochs' index orders are the same stream in both
    packages."""
    cfg, jcfg, buffer, jbuffer = t2v_corpus
    host = BucketedLoader(buffer, cfg, seed=3, shuffle=shuffle)
    idx_loader = BucketedLoader(buffer, cfg, seed=3, shuffle=shuffle)
    jidx_loader = JBucketedLoader(jbuffer, jcfg, seed=3, shuffle=shuffle)
    cache = DeviceResidentData(buffer, cfg, device="cpu")
    jcache = JDeviceResidentData(jbuffer, jcfg)
    assert cache.nbytes() > 0
    batches = list(zip(host.epoch(), idx_loader.epoch_indices(), jidx_loader.epoch_indices()))
    assert len(batches) == len(host) == 4
    shapes = set()
    for hb, idx, jidx in batches:
        assert list(idx) == [int(i) for i in jidx]
        got = cache.batch(idx)
        want = batch_to_device(hb, torch.device("cpu"))
        jwant = jcache.batch(jidx)
        assert set(got) == set(BATCH_KEYS)
        assert cache.batch_audiopaths(idx) == [buffer[i]["audiopath"] for i in idx]
        for k in BATCH_KEYS:
            assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jwant[k]), err_msg=k)
        shapes.add(tuple(got["attn_prior"].shape[1:]))
    assert len(shapes) > 1  # the batches fall in more than one bucket pair


@pytest.mark.parametrize("key,length,match", [("feat_gt_target", 40, "frame_buckets"),
                                              ("text_enc", 20, "text_buckets")])
def test_device_resident_data_rejects_overlong_item(t2v_corpus, key, length, match):
    """An item past the largest bucket (32 frames, 16 text ids) is refused
    at staging, as the host collate refuses the batch that holds it."""
    cfg, _, buffer, _ = t2v_corpus
    item = dict(buffer[0])
    t = length if key == "feat_gt_target" else item["feat_gt_target"].shape[0]
    n = length if key == "text_enc" else len(item["text_enc"])
    item["feat_gt_target"] = np.zeros((t, cfg.n_feat_dim), np.float32)
    item["text_enc"] = np.full(n, 3, np.int32)
    item["attn_prior"] = np.zeros((t, n), np.float32)
    long_buffer = buffer[1:] + [item]
    with pytest.raises(ValueError):
        BucketedLoader(long_buffer, cfg, shuffle=False).batch([len(long_buffer) - 1])
    with pytest.raises(ValueError, match=match):
        DeviceResidentData(long_buffer, cfg, device="cpu")


def test_device_resident_data_rejects_oversized_corpus(t2v_corpus, monkeypatch):
    """Past 80% of the card's memory the cache raises a sizing message in
    GiB before it allocates; the budget is monkeypatched, as the JAX test
    patches its device's ``bytes_limit``."""
    cfg, _, buffer, _ = t2v_corpus
    monkeypatch.setattr(device_cache, "device_memory_bytes", lambda device: 1024)
    with pytest.raises(ValueError, match="GiB"):
        DeviceResidentData(buffer, cfg, device="cpu")


# --- Vec2Wav ---------------------------------------------------------------------

# frames of the 5 items; item 4 is short (T <= 4 = seg_frames) and its wav
# runs 200 samples past T x 16
V2W_FRAMES = (10, 13, 16, 11, 3)
V2W_EXTRA = (0, 0, 0, 0, 200)


@pytest.fixture(scope="module")
def v2w_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("v2w")
    jcfg = dataclasses.replace(
        V2W_SMALL, feat_ground_truth=str(root / "w2v_feat"),
        train_wav_path=str(root / "aishell3"), spk_emb_path=str(root / "spk_emb"),
        input_training_file=str(root / "train.txt"), input_validation_file=str(root / "val.txt"),
        n_fft=64, win_size=64, hop_size=16, num_mels=8, frame_buckets=(16, 32), batch_size=2,
        split=True, segment_size=64, device_mel_target=True, device_resident_data=True)
    rng = np.random.default_rng(0)
    spk = "SSB001"
    (root / "w2v_feat" / "train" / spk).mkdir(parents=True)
    (root / "aishell3" / "train" / "wav" / spk).mkdir(parents=True)
    (root / "spk_emb").mkdir()
    np.save(root / "spk_emb" / f"{spk}.npy", rng.standard_normal(jcfg.spk_dim).astype(np.float32))
    lines = []
    for i, (t, extra) in enumerate(zip(V2W_FRAMES, V2W_EXTRA)):
        np.save(root / "w2v_feat" / "train" / spk / f"u{i}.npy",
                rng.standard_normal((1, t, jcfg.n_feat_dim)).astype(np.float32))
        wav = (rng.standard_normal(t * jcfg.total_upsample + extra) * 3000).astype(np.int16)
        wavfile.write(root / "aishell3" / "train" / "wav" / spk / f"u{i}.wav",
                      jcfg.sampling_rate, wav)
        lines.append(f"train/{spk}/u{i}.npy|text|{spk}")
    (root / "train.txt").write_text("\n".join(lines) + "\n")
    (root / "val.txt").write_text(lines[0] + "\n")
    cfg = _port(Vec2WavConfig, jcfg)
    files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    return cfg, jcfg, files


def test_vocoder_device_data_matches_jax(v2w_corpus):
    """Forced (idx, fstart), the short item included: the port's windows
    equal JAX's, bit for bit; ``draw_fstarts`` and the loader's
    ``epoch_indices`` are JAX's streams, and ``epoch_indices`` is the
    composition of ``epoch``'s batches."""
    cfg, jcfg, files = v2w_corpus
    ds, jds = VocoderDataset(files, cfg), JVocoderDataset(files, jcfg)
    cache = VocoderDeviceData(ds, cfg, device="cpu")
    jcache = JVocoderDeviceData(jds, jcfg)
    assert cache.nbytes() > 0 and cache.t_lens_host.tolist() == list(V2W_FRAMES)
    idx = np.array([0, 4, 2, 1], np.int32)
    fstart = np.array([6, 0, 12, 0], np.int32)
    got, want = cache.batch(idx, fstart=fstart), jcache.batch(idx, fstart=fstart)
    assert set(got) == set(want) == {"wv_feat", "spk_emb", "audio", "mel_frames"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert cache.batch_filenames(idx) == [files[i] for i in idx]
    all_idx = np.arange(len(files))
    for _ in range(3):
        np.testing.assert_array_equal(cache.draw_fstarts(all_idx), jcache.draw_fstarts(all_idx))
    draws = VocoderLoader(ds, 2, seed=9), JVocoderLoader(jds, 2, seed=9, num_workers=0)
    for _ in range(2):
        assert [list(b) for b in draws[0].epoch_indices()] == [
            list(b) for b in draws[1].epoch_indices()]
    names = [cache.batch_filenames(b) for b in VocoderLoader(ds, 2, seed=5).epoch_indices()]
    assert names == [b["filenames"] for b in VocoderLoader(ds, 2, seed=5, num_workers=0).epoch()]


def test_vocoder_device_data_zero_fills_short_item(v2w_corpus):
    """Item 4 (3 frames, a window of 4) has a wav 200 samples longer than
    3 x 16: the staged window holds its first 48 samples and zeros after,
    as JAX's device function gives, where the host path's window reads
    the next 16 real samples."""
    cfg, jcfg, files = v2w_corpus
    ds = VocoderDataset(files, cfg)
    got = VocoderDeviceData(ds, cfg, device="cpu").batch([4], fstart=[0])["audio"][0, :, 0]
    want = np.asarray(JVocoderDeviceData(JVocoderDataset(files, jcfg), jcfg).batch(
        np.array([4], np.int32), fstart=np.array([0], np.int32))["audio"])[0, :, 0]
    np.testing.assert_array_equal(got.numpy(), want)
    T, up = V2W_FRAMES[4], cfg.total_upsample
    _, audio, _ = ds.full_arrays(4)
    assert len(audio) == T * up + 200
    np.testing.assert_array_equal(got[:T * up].numpy(), audio[:T * up])
    assert not got[T * up:].any()
    host = ds[4]["audio"]  # the host path's window of the same item
    assert host.shape == got.shape
    assert np.any(host[T * up:] != 0) and np.array_equal(host[:T * up], audio[:T * up])


def test_vocoder_device_data_requirements(v2w_corpus, monkeypatch):
    """It raises as JAX's does without windows, with fine-tuning or
    without ``device_mel_target``; past the budget with a size in GiB."""
    cfg, _, files = v2w_corpus
    with pytest.raises(ValueError, match="split=True"):
        VocoderDeviceData(VocoderDataset(files, dataclasses.replace(
            cfg, split=False, device_mel_target=False)), cfg, device="cpu")
    with pytest.raises(ValueError, match="split=True"):
        VocoderDeviceData(VocoderDataset(files, cfg, fine_tuning=True), cfg, device="cpu")
    with pytest.raises(ValueError, match="device_mel_target"):
        VocoderDeviceData(VocoderDataset(files, cfg), dataclasses.replace(
            cfg, device_mel_target=False), device="cpu")
    monkeypatch.setattr(device_cache, "device_memory_bytes", lambda device: 1024)
    with pytest.raises(ValueError, match="GiB"):
        VocoderDeviceData(VocoderDataset(files, cfg), cfg, device="cpu")
