"""Windowed GAN data (``split=True``) and the fine-tuning branch of the
port's ``VocoderDataset`` against the JAX package's, on the tiny demo
corpus (``data/demo/vec2wav_tiny.json``: utterances of 16-42 latent frames,
windows of 25 frames and 8000 samples) and a temporary directory of
precomputed mels.

One seed draws the same windows in both packages: items are compared over
two passes (the second pass draws new windows), exactly, as are the
loader's batches (``num_workers=0``), their shapes, and ``mel_frames`` with
``device_mel_target`` (the in-step mel target's frames: 31 for a window).
"""

import dataclasses
import os

import numpy as np
import pytest

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.config import load_config as jax_load_config
from wavthruvec_pytorch_tpu.data import vocoder_data as jdata
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.data import vocoder_data as tdata

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join("data", "demo", "vec2wav_tiny.json")
SEED = 5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(port config, JAX config, training files, precomputed mel dir)."""
    cwd = os.getcwd()
    os.chdir(REPO)  # the config's paths are relative to the repository root
    try:
        cfg = dataclasses.replace(load_config(Vec2WavConfig, TINY), split=True)
        jcfg = dataclasses.replace(jax_load_config(JV2W, TINY), split=True)
        files, _ = tdata.get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
        cfg = dataclasses.replace(cfg, **{k: os.path.join(REPO, getattr(cfg, k)) for k in (
            "feat_ground_truth", "train_wav_path", "spk_emb_path")})
        jcfg = dataclasses.replace(jcfg, **{k: getattr(cfg, k) for k in (
            "feat_ground_truth", "train_wav_path", "spk_emb_path")})
    finally:
        os.chdir(cwd)
    mels = tmp_path_factory.mktemp("ft_mels")
    rng = np.random.default_rng(0)
    for f in _fine_tuning_files(files):  # keyed by base name, as the reference keys them
        t = np.load(os.path.join(cfg.feat_ground_truth, f)).shape[1]
        np.save(mels / (os.path.splitext(os.path.basename(f))[0] + ".npy"),
                rng.standard_normal((t * cfg.total_upsample // cfg.hop_size,
                                     cfg.num_mels)).astype(np.float32))
    return cfg, jcfg, files, str(mels)


def _fine_tuning_files(files):
    """The first file of each base name: the precomputed mels are keyed by
    base name (the demo's two speakers share file names), so only those pair a mel
    with its own audio."""
    seen, out = set(), []
    for f in files:
        base = os.path.basename(f)
        if base not in seen:
            seen.add(base)
            out.append(f)
    return out


def _assert_items_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("split,fine_tuning", [(True, False), (True, True), (False, True)])
def test_items_match_jax(corpus, split, fine_tuning):
    """Every item, over two passes, equals the JAX dataset's for one seed:
    features, audio, speaker embedding and host mel, bit for bit."""
    cfg, jcfg, files, mels = corpus
    if fine_tuning:
        files = _fine_tuning_files(files)
    kw = dict(fine_tuning=fine_tuning, base_mels_path=mels, split=split, seed=SEED)
    port, jax_ds = tdata.VocoderDataset(files, cfg, **kw), jdata.VocoderDataset(files, jcfg, **kw)
    seg_frames = cfg.segment_size // cfg.total_upsample
    lengths = set()
    for _ in range(2):
        for i in range(len(files)):
            got, want = port[i], jax_ds[i]
            _assert_items_equal(got, want)
            lengths.add(len(got["audio"]))
            if split and not fine_tuning:
                assert got["wv_feat"].shape == (seg_frames, cfg.n_feat_dim)
                assert len(got["audio"]) == seg_frames * cfg.total_upsample
    if split and fine_tuning:  # windows at hop granularity, or padded to the segment
        assert lengths <= {cfg.segment_size, -(-cfg.segment_size // cfg.hop_size) * cfg.hop_size}
    if fine_tuning:  # the audio is not normalised in the fine-tuning branch
        assert max(np.abs(port[i]["audio"]).max() for i in range(len(files))) < 0.95


def test_windows_move_between_passes(corpus):
    """A long item's window is drawn anew each pass; a short one is padded."""
    cfg, _, files, _ = corpus
    ds = tdata.VocoderDataset(files, cfg, seed=SEED)
    seg_frames = cfg.segment_size // cfg.total_upsample
    T = [np.load(os.path.join(cfg.feat_ground_truth, f)).shape[1] for f in files]
    long_i = int(np.argmax(T))
    short_i = int(np.argmin(T))
    assert T[long_i] > seg_frames > T[short_i]
    first = [ds[long_i]["wv_feat"] for _ in range(4)]
    assert any(not np.array_equal(first[0], w) for w in first[1:])
    short = ds[short_i]
    assert not short["wv_feat"][T[short_i]:].any() and not short["audio"][
        T[short_i] * cfg.total_upsample:].any()


@pytest.mark.parametrize("device_mel_target", [False, True])
def test_windowed_batches_match_jax(corpus, device_mel_target):
    """The loaders' windowed batches (shuffled by one seed, num_workers=0)
    equal JAX's: wv_feat [B, 25, C], audio [B, 8000, 1] and ``mel_loss``
    [B, 31, 80], or with ``device_mel_target`` no host mel but
    ``mel_frames``, 31 an item."""
    cfg, jcfg, files, _ = corpus
    cfg = dataclasses.replace(cfg, device_mel_target=device_mel_target)
    jcfg = dataclasses.replace(jcfg, device_mel_target=device_mel_target)
    got = list(tdata.VocoderLoader(tdata.VocoderDataset(files, cfg, seed=SEED), cfg.batch_size,
                                   seed=7, num_workers=0).epoch())
    want = list(jdata.VocoderLoader(jdata.VocoderDataset(files, jcfg, seed=SEED),
                                    jcfg.batch_size, seed=7, num_workers=0).epoch())
    assert len(got) == len(want) == len(files) // cfg.batch_size
    seg = cfg.segment_size // cfg.total_upsample
    n_mel = seg * cfg.total_upsample // cfg.hop_size
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["filenames"] == w["filenames"]
        assert g["wv_feat"].shape == (cfg.batch_size, seg, cfg.n_feat_dim)
        assert g["audio"].shape == (cfg.batch_size, seg * cfg.total_upsample, 1)
        if device_mel_target:
            assert "mel_loss" not in g and g["mel_frames"].tolist() == [n_mel] * cfg.batch_size
        else:
            assert g["mel_loss"].shape == (cfg.batch_size, n_mel, cfg.num_mels)
        for k in set(g) - {"filenames"}:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_device_mel_target_needs_windows(corpus):
    cfg, _, files, _ = corpus
    with pytest.raises(ValueError, match="split=True"):
        tdata.VocoderDataset(files, dataclasses.replace(cfg, device_mel_target=True),
                             split=False)


def test_loader_threads_and_options(corpus):
    """Whole utterances: worker threads give the serial loader's batches;
    an epoch draws distinct files and drops the last partial batch;
    ``close`` stops the threads."""
    cfg, _, files, _ = corpus
    cfg = dataclasses.replace(cfg, split=False)
    serial = list(tdata.VocoderLoader(tdata.VocoderDataset(files, cfg), 3, seed=7,
                                      num_workers=0).epoch())
    loader = tdata.VocoderLoader(tdata.VocoderDataset(files, cfg), 3, seed=7, num_workers=3)
    threaded = list(loader.epoch())
    assert loader._pool is not None
    loader.close()
    assert loader._pool is None
    for s, t in zip(serial, threaded):
        for k in ("wv_feat", "spk_emb", "audio", "mel_loss"):
            np.testing.assert_array_equal(s[k], t[k], err_msg=k)
    assert len(loader) == len(serial) == len(files) // 3 and len(files) % 3
    drawn = [f for b in serial for f in b["filenames"]]
    assert len(set(drawn)) == len(drawn) == 3 * len(serial) and set(drawn) <= set(files)
