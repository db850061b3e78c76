"""The port's mel op and vocoder data against the JAX package's on the CPU.

* ``ops.stft.mel_spectrogram`` against JAX's ``mel_spectrogram`` (whose DFT
  basis JAX builds in f32 in the graph) and against the port's host twin
  ``mel_spectrogram_np`` (the same f64-built basis): atol 1e-4 on the log-mel
  of N(0, 0.1^2) audio at the full config's n_fft 1024, hop 256.  Its
  gradient against ``jax.grad``: atol 1e-4 of the largest.
* ``VocoderDataset`` items, ``pad_vocoder_batch`` and the loader's batches on
  ``data/demo/vec2wav_tiny.json``: exact (the same numpy arithmetic).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.config import load_config as jax_load_config
from wavthruvec_pytorch_tpu.data import vocoder_data as jdata
from wavthruvec_pytorch_tpu.ops import stft as jstft
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, check_ported, load_config
from wavthruvec_pytorch_tpu_torch.data import vocoder_data as tdata
from wavthruvec_pytorch_tpu_torch.ops import stft as tstft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "data", "demo", "vec2wav_tiny.json")
FULL_MEL = dict(n_fft=1024, num_mels=80, sampling_rate=16000, hop_size=256, win_size=1024,
                fmin=0.0, fmax=None)


def _audio(B, L, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, L)) * 0.1).astype(np.float32)


def test_numpy_tables_equal_jax():
    """The port's copies of the filterbank, window and DFT basis: equal."""
    np.testing.assert_array_equal(tstft.mel_filterbank(16000, 1024, 80, 0.0, 8000.0),
                                  jstft.mel_filterbank(16000, 1024, 80, 0.0, 8000.0))
    np.testing.assert_array_equal(tstft.hann_window(800), jstft.hann_window(800))
    np.testing.assert_array_equal(tstft._dft_kernel(1024, 800), jstft._dft_kernel(1024, 800))


def test_mel_matches_jax_and_host_twin():
    """Full config's n_fft 1024, hop 256 on 2 x 16,000 samples: atol 1e-4
    against JAX's in-graph op and against the port's host twin."""
    y = _audio(2, 16000)
    got = tstft.mel_spectrogram(torch.tensor(y), **FULL_MEL).numpy()
    want = np.asarray(jstft.mel_spectrogram(jnp.asarray(y), **FULL_MEL))
    host = np.stack([tdata.mel_spectrogram_np(a, **FULL_MEL).T for a in y])
    assert got.shape == want.shape == host.shape == (2, 80, 16000 // 256)
    print(f"max |port - JAX| {np.abs(got - want).max():.3g}, "
          f"max |port - host| {np.abs(got - host).max():.3g}")
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, host, atol=1e-4)
    jhost = jdata.mel_spectrogram_np(y[0], **FULL_MEL)
    np.testing.assert_array_equal(tdata.mel_spectrogram_np(y[0], **FULL_MEL), jhost)


@pytest.mark.parametrize("n_fft,hop,win,center", [(64, 16, 64, False), (64, 24, 48, True)])
def test_stft_magnitude_matches_jax(n_fft, hop, win, center):
    """A hop that divides n_fft (JAX slices) and one that does not (JAX
    convolves), a window shorter than n_fft, and ``center``: atol 1e-5."""
    y = _audio(2, 600, seed=1)
    got = tstft.stft_magnitude(torch.tensor(y), n_fft, hop, win, center=center).numpy()
    want = np.asarray(jstft.stft_magnitude(jnp.asarray(y), n_fft, hop, win, center=center))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mel_gradient_matches_jax():
    """d sum(w * log-mel) / dy against jax.grad (n_fft 64, hop 16, 8 mels):
    atol 1e-4 of the largest."""
    y = _audio(2, 512, seed=2)
    kw = dict(n_fft=64, num_mels=8, sampling_rate=16000, hop_size=16, win_size=64, fmin=0.0,
              fmax=None)
    w = np.random.default_rng(3).standard_normal((2, 8, 32)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jstft.mel_spectrogram(a, **kw) * w))(
        jnp.asarray(y)))
    yt = torch.tensor(y, requires_grad=True)
    (tstft.mel_spectrogram(yt, **kw) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(yt.grad.numpy(), want, atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module")
def tiny_data():
    jcfg = jax_load_config(JV2W, TINY)
    cfg = load_config(Vec2WavConfig, TINY)
    cwd = os.getcwd()
    os.chdir(REPO)  # the config's paths are relative to the repository
    try:
        files, _ = tdata.get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
        assert files == jdata.get_dataset_filelist(jcfg.input_training_file,
                                                   jcfg.input_validation_file)[0]
        port = tdata.VocoderDataset(files, cfg)
        jax_ds = jdata.VocoderDataset(files, jcfg)
        items = [(port[i], jax_ds[i]) for i in range(len(files))]
        batches = [(list(tdata.VocoderLoader(port, cfg.batch_size, seed=7).epoch()),
                    list(jdata.VocoderLoader(jax_ds, jcfg.batch_size, seed=7, num_workers=0,
                                             pad_to_max=False).epoch()))]
    finally:
        os.chdir(cwd)
    return cfg, jcfg, items, batches


def test_vocoder_items_equal_jax(tiny_data):
    _, _, items, _ = tiny_data
    assert len(items) == 10
    for got, want in items:
        assert got["filename"] == want["filename"]
        for k in ("wv_feat", "spk_emb", "audio", "mel_loss"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pad_vocoder_batch_equal_jax(tiny_data):
    """Items padded (and cut) to the config's one frame bucket of 40: the
    host-mel batch and the ``mel_frames`` batch of the in-step target."""
    cfg, jcfg, items, _ = tiny_data
    longest = sorted(items, key=lambda pair: pair[0]["wv_feat"].shape[0])[-4:]
    port_items = [p for p, _ in longest]
    jax_items = [j for _, j in longest]
    assert max(it["wv_feat"].shape[0] for it in port_items) > 40  # one is cut
    for strip in (False, True):
        def keep(it):
            return {k: v for k, v in it.items() if not (strip and k == "mel_loss")}

        got = tdata.pad_vocoder_batch([keep(it) for it in port_items], cfg)
        want = jdata.pad_vocoder_batch([keep(it) for it in jax_items], jcfg)
        assert set(got) == set(want)
        assert got["filenames"] == want["filenames"]
        for k in set(got) - {"filenames"}:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_loader_batches_equal_jax(tiny_data):
    """The loader's epoch, shuffled by the same seed: the same batches."""
    _, _, _, [(got, want)] = tiny_data
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["filenames"] == w["filenames"]
        for k in ("wv_feat", "spk_emb", "audio", "mel_loss"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("flag", ["split", "device_resident_data"])
def test_gan_data_flags_refused(flag):
    """Neither GAN data flag is refused any more: windowed training and the
    device-resident data are ported and pass ``check_ported``; the dataset
    builds with either."""
    cfg = Vec2WavConfig(**{flag: True})
    check_ported(cfg)
    ds = tdata.VocoderDataset([], cfg)
    assert ds.split == (flag == "split")
