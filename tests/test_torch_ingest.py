"""The port's ``prepare_data`` (``data/ingest.py``) end to end against the
JAX package's on the CPU: the same AISHELL-3-shaped tree and content.txt,
the tiny wav2vec 2.0 of ``tests/test_ingest_featurizer.py`` with Flax's
seeded weights carried into the port.  The filelists and the vocabulary are
identical; every latent file has JAX's shape and values within atol 2e-4."""

import os

import numpy as np
import pytest

import jax

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_ingest_featurizer import TINY_W2V
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.data import ingest
from wavthruvec_pytorch_tpu_torch.models.wav2vec2 import Wav2Vec2Config

SPEAKERS = ("SSB0005", "SSB0011", "SSB0042")


def _tree(root):
    """3 speakers x 5 wavs of 0.2-0.9 s; one wav without a label, labels with
    pinyin, digits and punctuation to strip."""
    from scipy.io import wavfile

    rng = np.random.default_rng(1)
    lines = []
    for s, spk in enumerate(SPEAKERS):
        os.makedirs(root / "wav" / spk)
        for i in range(5):
            n = int(rng.integers(3200, 14400))
            wav = (rng.standard_normal(n) * 3000).astype(np.int16)
            name = f"{spk}{i:04d}.wav"
            wavfile.write(root / "wav" / spk / name, 16000, wav)
            if (s, i) != (1, 3):
                lines.append(f"{name}\t你 ni3 好{i} hao3 世{s}界 Jie4.?")
    (root / "content.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")


def _run(prepare, featurizer, root, name):
    out = root / name
    prepare(str(root / "wav"), str(out / "feat"), str(root / "content.txt"),
            str(out / "train.txt"), str(out / "val.txt"), str(out / "vocab.txt"), featurizer,
            n_speakers=3, n_files_per_speaker=5, batch_size=2)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from wavthruvec_pytorch_tpu.data import ingest as jingest

    root = tmp_path_factory.mktemp("ingest")
    _tree(root)
    jf = jingest.Wav2VecFeaturizer(random_init=True, config_overrides=TINY_W2V,
                                   wav_buckets=(8000, 16000))
    tf = ingest.Wav2VecFeaturizer(random_init=True, config_overrides=TINY_W2V,
                                  wav_buckets=(8000, 16000), device="cpu")
    tf.model.load_state_dict(weights.wav2vec2_state_dict(
        jax.tree_util.tree_map(np.asarray, jf.model.params),
        Wav2Vec2Config.from_dict(TINY_W2V)), strict=True)
    return _run(jingest.prepare_data, jf, root, "jax"), _run(ingest.prepare_data, tf, root, "port")


@pytest.mark.parametrize("name", ["train.txt", "val.txt", "vocab.txt"])
def test_lists_and_vocab_identical(both, name):
    jax_out, port_out = both
    assert (port_out / name).read_bytes() == (jax_out / name).read_bytes()


def test_lists_content(both):
    """Even index within a speaker to train, odd to val; the unlabelled wav
    is featurized but listed nowhere; the vocabulary is 'PE ' + sorted."""
    _, out = both
    train = (out / "train.txt").read_text(encoding="utf-8").splitlines()
    val = (out / "val.txt").read_text(encoding="utf-8").splitlines()
    assert len(train) == 9 and len(val) == 5
    assert all(int(line.split("|")[0][-8:-4]) % 2 == 0 for line in train)
    assert not any("SSB00110003" in line for line in train + val)
    assert os.path.exists(out / "feat" / "SSB0011" / "SSB00110003.npy")
    assert train[0].split("|")[1] == "你好世界"
    vocab = (out / "vocab.txt").read_text(encoding="utf-8")
    assert vocab.startswith("PE ") and list(vocab[3:]) == sorted(set(vocab[3:]))


def test_latents_match_jax(both):
    jax_out, port_out = both
    n = 0
    for spk in SPEAKERS:
        for f in sorted(os.listdir(jax_out / "feat" / spk)):
            want = np.load(jax_out / "feat" / spk / f)
            got = np.load(port_out / "feat" / spk / f)
            assert got.shape == want.shape and got.dtype == np.float32 and got.shape[0] == 1
            np.testing.assert_allclose(got, want, atol=2e-4, err_msg=f)
            n += 1
    assert n == 15


@pytest.mark.parametrize("text,want", [("你 ni3 好 hao3", "你好"), ("ABC,d 中。", ",中。"),
                                       ("  上海 ", "上海")])
def test_clean_label_text(text, want):
    from wavthruvec_pytorch_tpu.data.ingest import clean_label_text as jclean

    assert ingest.clean_label_text(text) == jclean(text) == want
