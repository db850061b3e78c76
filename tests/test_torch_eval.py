"""The port's Text2Vec evaluation (``infer/eval.py``, ``cli eval-text2vec``)
against the JAX package's on the CPU: JAX's seeded weights written as the
reference's ``checkpoint_{step}.pth.tar`` and loaded by the port, the same
sentences and reference clips.  The config is ``tests/test_torch_train.py``'s
(the JAX BiGRU's Pallas forward in interpret mode, the port's numerics).
Durations and frame counts exact, the features before the postnet atol
1e-4, after it 1e-3 (the BiGRU's bf16 ``w_hh``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import JCFG
from wavthruvec_pytorch_tpu_torch import cli, weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, repo_path
from wavthruvec_pytorch_tpu_torch.infer import eval as t2v_eval
from wavthruvec_pytorch_tpu_torch.text import TextFrontend


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from wavthruvec_pytorch_tpu.infer import eval as jeval
    from wavthruvec_pytorch_tpu.text import TextFrontend as JFrontend

    tmp = tmp_path_factory.mktemp("eval")
    chars = sorted(set("".join(t2v_eval.TEST_SENTENCES[:2])))
    (tmp / "vocab.txt").write_text("PE " + "".join(chars), encoding="utf-8")
    jcfg = dataclasses.replace(JCFG, text_buckets=(32,), vocab_path=str(tmp / "vocab.txt"))
    cfg = Text2VecConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(Text2VecConfig)})
    jmodel, jvars = jeval.load_model(jcfg, str(tmp / "none"), 0)
    jvars = jax.tree_util.tree_map(np.asarray, jvars)
    (tmp / "ckpt").mkdir()
    torch.save({"model": weights.text2vec_state_dict(jvars, jcfg)},
               tmp / "ckpt" / "checkpoint_3.pth.tar")
    return dict(jeval=jeval, jmodel=jmodel, jvars=jvars, jcfg=jcfg, cfg=cfg, tmp=tmp,
                jfrontend=JFrontend.from_vocab_file(jcfg.vocab_path),
                frontend=TextFrontend.from_vocab_file(cfg.vocab_path))


def test_test_sentences_are_the_references():
    from wavthruvec_pytorch_tpu.infer.eval import TEST_SENTENCES

    assert t2v_eval.TEST_SENTENCES == TEST_SENTENCES


@pytest.mark.parametrize("i", [0, 1])
def test_synthesize_one_matches_jax(setup, i, capsys):
    s = setup
    model = t2v_eval.load_model(s["cfg"], str(s["tmp"] / "ckpt"), 3, device="cpu")
    assert "loaded checkpoint_3.pth.tar" in capsys.readouterr().out
    ref = np.random.default_rng(i).standard_normal((20, s["cfg"].n_feat_dim)) * 0.1
    sentence = t2v_eval.TEST_SENTENCES[i]
    want = s["jeval"].synthesize_one(s["jmodel"], s["jvars"], s["jcfg"], s["jfrontend"],
                                     sentence, ref, 1.5)
    got = t2v_eval.synthesize_one(model, s["cfg"], s["frontend"], sentence, ref, 1.5)
    assert got[0].shape == want[0].shape and got[0].shape[0] > 0
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=1e-3)


def test_random_init_warns(setup, capsys):
    model = t2v_eval.load_model(setup["cfg"], str(setup["tmp"] / "none"), 0, device="cpu")
    assert "WARNING: no checkpoint" in capsys.readouterr().out
    assert not model.training


def test_cli_writes_the_features_and_times_them(tmp_path, capsys):
    """``eval-text2vec --rtf`` on the tiny demo config (random weights): two
    sentences' features written, the RTF printed."""
    rc = cli.main(["eval-text2vec", "--config", repo_path("data", "demo", "text2vec_tiny.json"),
                   "--checkpoint_path", str(tmp_path / "none"), "--step", "5",
                   "--n_sentences", "2", "--results_dir", str(tmp_path / "results"),
                   "--log_seed", "x", "--rtf", "--rtf_iters", "2", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "WARNING: no checkpoint" in out and "t2v RTF:" in out
    names = sorted(os.listdir(tmp_path / "results" / "x"))
    assert names == ["5_0_feat.npy", "5_0_feat.postnet.npy", "5_1_feat.npy",
                     "5_1_feat.postnet.npy"]
    feat = np.load(tmp_path / "results" / "x" / "5_0_feat.postnet.npy")
    assert feat.shape[1] == 64 and np.isfinite(feat).all()
