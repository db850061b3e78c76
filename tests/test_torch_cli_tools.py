"""The port's data-preparation and model-upkeep subcommands run on the CPU
(``--device cpu``) with the tiny demo configs and exit 0: ``make-demo-data``,
``prepare-data``, ``pre-spk-emb``, ``recalibrate-bn`` and
``eval-text2vec``.  Their results are held against the JAX package in
``test_torch_demo.py``, ``test_torch_ingest.py``, ``test_torch_spk_emb.py``,
``test_torch_recalibrate.py`` and ``test_torch_eval.py``."""

import os
import shutil

import numpy as np
import pytest
import torch

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_ingest_featurizer import TINY_W2V
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config, repo_path
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.wav2vec2 import Wav2Vec2Config, random_model, save_pretrained

DEMO = repo_path("data", "demo")
T2V_TINY = os.path.join(DEMO, "text2vec_tiny.json")
WAVS = os.path.join(DEMO, "aishell3", "train", "wav")


def _prepare_data(tmp):
    shutil.copytree(WAVS, tmp / "wav")
    lines = [f"{f}\t{spk[-1]}号 ni3 hao3" for spk in sorted(os.listdir(WAVS))
             for f in sorted(os.listdir(os.path.join(WAVS, spk)))]
    (tmp / "content.txt").write_text("\n".join(lines) + "\n", encoding="utf-8")
    save_pretrained(random_model(Wav2Vec2Config.from_dict(TINY_W2V), device="cpu"), tmp / "w2v")
    return ["--wavs_path", str(tmp / "wav"), "--feat_output_path", str(tmp / "feat"),
            "--label_file_path", str(tmp / "content.txt"),
            "--enc_train_list_path", str(tmp / "train.txt"),
            "--enc_val_list_path", str(tmp / "val.txt"), "--vocab_path", str(tmp / "vocab.txt"),
            "--model_path", str(tmp / "w2v"), "--batch_size", "4"]


def _recalibrate_bn(tmp):
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = Text2Vec(load_config(Text2VecConfig, T2V_TINY), device="cpu")
    torch.save({"model": model.state_dict(), "epoch": 1}, tmp / "checkpoint_2.pth.tar")
    return ["--t2v_checkpoint", str(tmp / "checkpoint_2.pth.tar"),
            "--filelist", os.path.join(DEMO, "enc_val.txt"),
            "--feat_root", os.path.join(DEMO, "w2v_feat_tiny"), "--config", T2V_TINY,
            "--out", str(tmp / "out")]


ARGS = {
    "make-demo-data": lambda tmp: ["--root", str(tmp / "demo"), "--n_utts", "2"],
    "prepare-data": _prepare_data,
    "pre-spk-emb": lambda tmp: ["--wavs_root", WAVS, "--out_dir", str(tmp / "emb"),
                                "--n_files_per_speaker", "2"],
    "recalibrate-bn": _recalibrate_bn,
    "eval-text2vec": lambda tmp: ["--config", T2V_TINY, "--n_sentences", "1",
                                  "--results_dir", str(tmp / "results")],
}
OUTPUTS = {
    "make-demo-data": "demo/text2vec_tiny.json",
    "prepare-data": "feat/SSB0001/u5.npy",
    "pre-spk-emb": "emb/SSB0001.npy",
    "recalibrate-bn": "out/checkpoint_2.pth.tar",
    "eval-text2vec": "results/1/0_0_feat.postnet.npy",
}


@pytest.mark.parametrize("cmd", sorted(ARGS))
def test_cli_ported_tools_run_on_cpu(cmd, tmp_path):
    """Run from the repository root, as the demo configs' relative paths
    want."""
    assert cli.main([cmd, *ARGS[cmd](tmp_path), "--device", "cpu"]) == 0
    assert os.path.isfile(tmp_path / OUTPUTS[cmd])
    if OUTPUTS[cmd].endswith(".npy"):
        assert np.isfinite(np.load(tmp_path / OUTPUTS[cmd])).all()


def test_only_export_torch_is_not_ported():
    """Every subcommand is ported now, ``export-torch`` last: the table of
    unported ones is gone and ``export-torch`` takes the JAX command's
    flags."""
    assert not hasattr(cli, "NOT_PORTED")
    with pytest.raises(SystemExit) as e:
        cli.main(["export-torch", "--help"])
    assert e.value.code == 0


def test_prepare_data_needs_weights(tmp_path):
    """Without --model_path or --random_init nothing is fetched: it raises."""
    with pytest.raises(ValueError, match="model_path"):
        cli.main(["prepare-data", "--wavs_path", str(tmp_path), "--feat_output_path",
                  str(tmp_path / "f"), "--label_file_path", str(tmp_path / "c.txt"),
                  "--device", "cpu"])
