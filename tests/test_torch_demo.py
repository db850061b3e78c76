"""The port's ``make-demo-data`` (``data/demo.py``) against the JAX
package's: with the same seed and sizes both write the same files, byte for
byte (vocabulary, filelists, wavs, latents, speaker embeddings and the
config files), and the configs load into both packages."""

import dataclasses
import os

import pytest

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.data.demo import make_demo_data


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("seed,n_speakers,n_utts,max_frames", [(0, 2, 3, 0), (7, 3, 2, 20)])
def test_same_files_as_jax(tmp_path, seed, n_speakers, n_utts, max_frames):
    from wavthruvec_pytorch_tpu.data.demo import make_demo_data as jax_make

    kw = dict(n_speakers=n_speakers, n_utts=n_utts, seed=seed, n_feat_dim=96,
              max_frames=max_frames)
    jax_make(str(tmp_path / "demo"), **kw)
    want = _files(tmp_path / "demo")
    os.rename(tmp_path / "demo", tmp_path / "jax")
    make_demo_data(str(tmp_path / "demo"), **kw)
    got = _files(tmp_path / "demo")
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.endswith(".wav")]) == n_speakers * n_utts
    for name in sorted(want):
        assert got[name] == want[name], name


def test_configs_load_into_both(tmp_path):
    from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
    from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
    from wavthruvec_pytorch_tpu.config import load_config as jload

    assert cli.main(["make-demo-data", "--root", str(tmp_path / "d"), "--n_utts", "2",
                     "--seed", "3", "--device", "cpu"]) == 0
    for name, cls, jcls in (("text2vec", Text2VecConfig, JT2V), ("vec2wav", Vec2WavConfig, JV2W)):
        for suffix in ("", "_tiny"):
            path = str(tmp_path / "d" / f"{name}{suffix}.json")
            ours, theirs = load_config(cls, path), jload(jcls, path)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    t2v = load_config(Text2VecConfig, str(tmp_path / "d" / "text2vec.json"))
    with open(t2v.vocab_path, encoding="utf-8") as f:
        assert t2v.vocab_size == len(f.readline()) == 123
