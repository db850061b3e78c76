"""Both training loops as jobs on the CPU, on the tiny demo configs: their
files, logs, resume, frozen lr and validation; the two validations against
the JAX package's; the ``train-*`` subcommands; both loops fed from the
device caches (``device_resident_data``).

Tolerances: ``compute_validation_loss`` against JAX's over the same batches
and weights, rtol 1e-5 (f32 both sides, the step's loss tolerance in
``tests/test_torch_train.py``); the GAN validation's mel L1 against JAX
``make_val_fn``'s with the same noise, rtol 1e-4 (the Generator's waveform
agrees to 2e-4; the log-mel's near-silent bins, clipped at 1e-5, amplify
that, and 1.3e-5 was measured).
Files and resumed step numbers are compared exactly.
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint_io import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import JCFG, _init_params, _items, _randomize_stats
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.config import load_config as jax_load_config
from wavthruvec_pytorch_tpu.data.dataset import BucketedLoader as JBucketedLoader
from wavthruvec_pytorch_tpu.data.vocoder_data import VocoderDataset as JVocoderDataset
from wavthruvec_pytorch_tpu.data.vocoder_data import pad_vocoder_batch as jpad
from wavthruvec_pytorch_tpu.models import vec2wav as jv
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.train import text2vec_loop as jt2v_loop
from wavthruvec_pytorch_tpu.train import vec2wav_loop as jv2w_loop
from wavthruvec_pytorch_tpu_torch import cli, weights
from wavthruvec_pytorch_tpu_torch.config import (
    Text2VecConfig,
    Vec2WavConfig,
    check_ported,
    load_config,
    save_config,
)
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import VocoderDataset, get_dataset_filelist
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.train import text2vec_loop, vec2wav_loop
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import VAL_KEYS, Text2VecTrainer
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer
from wavthruvec_pytorch_tpu_torch.utils import logging as tlogging
from wavthruvec_pytorch_tpu_torch.utils.plots import plot_alignment_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2V_TINY = os.path.join("data", "demo", "text2vec_tiny.json")
V2W_TINY = os.path.join("data", "demo", "vec2wav_tiny.json")


class FakeWriter:
    """A stand-in for TensorBoard's ``SummaryWriter`` that records calls."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("add_"):
            return lambda tag, *a, **k: self.calls.append((name, tag))
        raise AttributeError(name)

    def flush(self):
        pass

    def close(self):
        pass


@pytest.fixture
def jsonl_logger(monkeypatch):
    """Scalars to ``scalars.jsonl``: TensorBoard cannot be imported."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture
def fake_tensorboard(monkeypatch):
    """A TensorBoard writer that records its calls (``writers``)."""
    writers = []

    def make(log_dir):
        writers.append(FakeWriter(log_dir))
        return writers[-1]

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=make))
    return writers


def _scalars(path):
    with open(path, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    out = {}
    for r in rows:
        out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


def _t2v_cfg(tmp_path):
    return dataclasses.replace(load_config(Text2VecConfig, T2V_TINY), run_path=str(tmp_path),
                               save_step=2, log_step=2, val_step=2)


def _t2v_args(*flags):
    return text2vec_loop.parse_args(["--device", "cpu", *flags])


def _files_with_mtimes(path):
    return {f: os.stat(os.path.join(path, f)).st_mtime_ns for f in os.listdir(path)}


# --- the Text2Vec loop ----------------------------------------------------------

def test_text2vec_loop_files_logs_validation_and_resume(monkeypatch, tmp_path, jsonl_logger):
    """4 steps with --validate: checkpoint_2/4, the config snapshot, the text
    log and one scalar of each loss a step, the validation's losses at steps
    2 and 4.  Then --restore_step 4 goes on at step 5 from checkpoint_4's
    state; --restore_step 4 --max_steps 4 trains and writes nothing; a
    missing checkpoint raises."""
    monkeypatch.chdir(REPO)
    cfg = _t2v_cfg(tmp_path)
    rec = text2vec_loop.main(_t2v_args("--max_steps", "4", "--validate"), cfg=cfg)
    run = os.path.join(str(tmp_path), cfg.log_seed)
    assert rec.backend == "jsonl"
    assert sorted(os.listdir(os.path.join(run, "model_new"))) == [
        "checkpoint_2.pth.tar", "checkpoint_4.pth.tar"]
    assert sorted(rec.steps) == [1, 2, 3, 4] and sorted(rec.saves) == [2, 4]
    snapshot = load_config(Text2VecConfig, os.path.join(run, "config.json"))
    assert snapshot == dataclasses.replace(cfg, vocab_size=snapshot.vocab_size)
    with open(os.path.join(run, "logger", "logger.txt"), encoding="utf-8") as f:
        text = f.read()
    assert "Step [2/" in text and "Step [4/" in text and "Validation at step 4" in text
    scalars = _scalars(os.path.join(run, "tb_logs", "scalars.jsonl"))
    assert sorted(scalars["train/total_loss"]) == [1, 2, 3, 4]
    np.testing.assert_allclose([scalars["train/total_loss"][s] for s in range(1, 5)],
                               [rec.steps[s]["total_loss"] for s in range(1, 5)])
    for k in VAL_KEYS:
        assert sorted(scalars[f"val/{k}"]) == [2, 4]
        assert scalars[f"val/{k}"][4] == pytest.approx(rec.validations[4][k])
    assert scalars["val/nonfinite_batches"] == {2: 0, 4: 0}

    resumed = text2vec_loop.main(_t2v_args("--max_steps", "5", "--restore_step", "4"), cfg=cfg)
    assert list(resumed.steps) == [5]
    before = _files_with_mtimes(cfg.checkpoint_path)
    done = text2vec_loop.main(_t2v_args("--max_steps", "4", "--restore_step", "4"), cfg=cfg)
    assert done.steps == {} and done.saves == {}
    assert _files_with_mtimes(cfg.checkpoint_path) == before
    with pytest.raises(FileNotFoundError):
        text2vec_loop.main(_t2v_args("--max_steps", "5", "--restore_step", "3"), cfg=cfg)


def test_text2vec_frozen_lr(monkeypatch, tmp_path, jsonl_logger):
    """--frozen_learning_rate holds the lr at --learning_rate_frozen, also
    over a restore (which loads the saved lr): the log and the file say so."""
    monkeypatch.chdir(REPO)
    cfg = _t2v_cfg(tmp_path)
    text2vec_loop.main(_t2v_args("--max_steps", "2"), cfg=cfg)
    text2vec_loop.main(_t2v_args("--max_steps", "4", "--restore_step", "2",
                                 "--frozen_learning_rate", "True", "--learning_rate_frozen",
                                 "0.003"), cfg=cfg)
    obj = torch.load(os.path.join(cfg.checkpoint_path, "checkpoint_4.pth.tar"),
                     map_location="cpu", weights_only=False)
    assert obj["learning_rate"] == 0.003
    assert all(g["lr"] == 0.003 for g in obj["optimizer"]["param_groups"])
    with open(os.path.join(cfg.logger_path, "logger.txt"), encoding="utf-8") as f:
        assert "Current Learning Rate is 0.003000." in f.read()


def test_text2vec_loop_alignment_images(monkeypatch, tmp_path, fake_tensorboard):
    """With a TensorBoard writer (and matplotlib) every log step sends item
    0's soft and hard alignment images; scalars go to the writer."""
    monkeypatch.chdir(REPO)
    rec = text2vec_loop.main(_t2v_args("--max_steps", "2"), cfg=_t2v_cfg(tmp_path))
    assert rec.backend == "tensorboard"
    calls = fake_tensorboard[0].calls
    assert ("add_image", "train/attention_weights(align_soft)") in calls
    assert ("add_image", "train/attention_weights_mas(align_hard)") in calls
    assert sum(1 for c in calls if c == ("add_scalar", "train/total_loss")) == 2
    image = plot_alignment_to_numpy(np.random.default_rng(0).random((5, 9)), title="u0.npy")
    assert image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3


def test_logger_backends(tmp_path, monkeypatch):
    """Without TensorBoard the scalars go to scalars.jsonl and images,
    audio and figures are dropped; text goes to logger.txt."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = tlogging.TrainLogger(str(tmp_path / "tb"), str(tmp_path / "log"))
    assert logger.backend == "jsonl" and not logger.takes_figures
    logger.add_scalar("a", 1.5, 3)
    logger.add_image("img", np.zeros((2, 2, 3), np.uint8), 3)
    logger.text("one", "two")
    logger.close()
    assert _scalars(str(tmp_path / "tb" / "scalars.jsonl")) == {"a": {3: 1.5}}
    assert (tmp_path / "log" / "logger.txt").read_text() == "one\ntwo\n\n"


# --- validation against JAX -----------------------------------------------------

class _NullLogger:
    def add_scalar(self, *a):
        pass


def test_compute_validation_loss_matches_jax():
    """The eval-mode losses over two validation batches (B = 4, file order)
    == JAX ``compute_validation_loss`` with ``make_val_fn`` on the same
    weights and BatchNorm statistics: rtol 1e-5."""
    cfg = Text2VecConfig(**{f.name: getattr(JCFG, f.name)
                            for f in dataclasses.fields(Text2VecConfig)})
    lengths = [(12, 64), (9, 60), (5, 57), (7, 50), (16, 64), (10, 62), (8, 40), (11, 58)]
    buffer = _items(cfg, lengths, seed=21)
    val_cfg = dataclasses.replace(cfg, batch_size=4, batch_expand_size=1)
    jval_cfg = dataclasses.replace(JCFG, batch_size=4, batch_expand_size=1)
    loader = BucketedLoader(buffer, val_cfg, shuffle=False)
    jloader = JBucketedLoader(buffer, jval_cfg, shuffle=False)
    assert len(loader) == len(jloader) == 2

    model = JText2Vec(JCFG)
    first = {k: jnp.asarray(v) for k, v in next(jloader.epoch()).items() if k != "audiopaths"}
    shapes = jax.eval_shape(lambda key: model.init(
        {"params": key, "dropout": key}, first["text"], first["src_pos"], first["feat_target"],
        first["input_lengths"], first["output_lengths"], first["feat_pos"],
        attn_prior=first["attn_prior"], deterministic=True, train_bn=False),
        jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 22)
    stats = _randomize_stats(shapes["batch_stats"], 22)
    want = jt2v_loop.compute_validation_loss(
        model, JCFG, types.SimpleNamespace(params=params, batch_stats=stats), jloader,
        _NullLogger(), 7)

    trainer = Text2VecTrainer(cfg, device="cpu")
    trainer.model.load_state_dict(
        weights.text2vec_state_dict({"params": params, "batch_stats": stats}, JCFG), strict=True)
    got = text2vec_loop.compute_validation_loss(trainer, loader, _NullLogger(), 7)
    assert trainer.model.training  # back in train mode
    assert got["nonfinite_batches"] == want["nonfinite_batches"] == 0
    print("validation port", got, "JAX", want)
    for k in VAL_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_validation_counts_nonfinite_batches(monkeypatch):
    """A non-finite batch is counted and left out of the means."""
    trainer = types.SimpleNamespace()
    values = iter([{k: torch.tensor(1.0) for k in VAL_KEYS},
                   {k: torch.tensor(float("inf")) for k in VAL_KEYS},
                   {k: torch.tensor(3.0) for k in VAL_KEYS}])
    trainer.validation_losses = lambda batch: next(values)
    loader = types.SimpleNamespace(epoch=lambda: iter(range(3)))
    logged = {}

    class Logger:
        def add_scalar(self, tag, value, step):
            logged[tag] = value

    got = text2vec_loop.compute_validation_loss(trainer, loader, Logger(), 5)
    assert got == dict({k: 2.0 for k in VAL_KEYS}, nonfinite_batches=1)
    assert logged["val/nonfinite_batches"] == 1 and logged["val/WVF_loss"] == 2.0


def test_gan_validate_matches_jax(monkeypatch):
    """``validate``'s mel L1 over the demo validation set (2 whole
    utterances, each padded to its frame bucket) == JAX ``make_val_fn``'s
    mean with the same noise: rtol 1e-4; the Generator goes back to train
    mode.  The tiny demo config with two upsampling stages (x16), so that
    JAX compiles a small Generator: the items' audio is cut to the
    bucket's 1024 samples, in both packages alike."""
    monkeypatch.chdir(REPO)
    small = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                 resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                 frame_buckets=(64,))
    cfg = dataclasses.replace(load_config(Vec2WavConfig, V2W_TINY), **small)
    jcfg = dataclasses.replace(jax_load_config(JV2W, V2W_TINY), **small)
    _, val_files = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    validset = VocoderDataset(val_files, cfg, split=False, compute_mel=True)
    jvalidset = JVocoderDataset(val_files, jcfg, split=False, compute_mel=True)
    noise = np.random.default_rng(3).standard_normal((len(val_files), cfg.noise_dim)
                                                     ).astype(np.float32)
    jgen = jv.Generator(jcfg, fused=False)
    first = jpad([jvalidset[0]], jcfg)
    gen_vars = jax.tree_util.tree_map(np.asarray, jgen.init(
        jax.random.PRNGKey(3), jnp.asarray(first["wv_feat"]), jnp.asarray(first["spk_emb"]),
        jnp.asarray(noise[:1]), train=False))
    val_fn = jv2w_loop.make_val_fn(types.SimpleNamespace(gen=jgen), jcfg)
    errs = []
    for j in range(len(val_files)):
        b = jpad([jvalidset[j]], jcfg)
        errs.append(float(val_fn(gen_vars, jnp.asarray(b["wv_feat"]), jnp.asarray(b["spk_emb"]),
                                 jnp.asarray(noise[j:j + 1]), jnp.asarray(b["mel_loss"]))[0]))

    gen = Generator(cfg, device="cpu", fused=False).train()
    gen.load_state_dict(weights.generator_state_dict(gen_vars, jcfg), strict=True)
    # validate reads the trainer's config, Generator and device only
    trainer = types.SimpleNamespace(cfg=cfg, gen=gen, device=torch.device("cpu"))
    logged = {}
    logger = types.SimpleNamespace(tb=None, takes_figures=False,
                                   add_scalar=lambda tag, v, s: logged.update({tag: v}))
    got = vec2wav_loop.validate(trainer, validset, logger, 10, noise=noise)
    assert trainer.gen.training
    print(f"GAN validation mel L1 port {got:.6f}, JAX {np.mean(errs):.6f}")
    np.testing.assert_allclose(got, np.mean(errs), rtol=1e-4)
    assert logged["validation/mel_spec_error"] == got


# --- the GAN loop ---------------------------------------------------------------

def test_vec2wav_loop_windowed_resume_and_logs(monkeypatch, tmp_path, fake_tensorboard):
    """Windowed (split=True): 3 steps save g_/do_ 2 (a save step and the
    last) and validate there with audio and spectrograms of both items,
    the scalars logged every step; the pair loads with its AdamW state; a
    second run resumes from do_00000002 at step 3 and saves 3, its last; a
    third run with the same --max_steps trains and writes nothing."""
    monkeypatch.chdir(REPO)
    cfg = dataclasses.replace(load_config(Vec2WavConfig, V2W_TINY), split=True,
                              run_path=str(tmp_path), save_step=2, val_step=2, log_step=1)
    args = ["--device", "cpu", "--num_workers", "2"]
    first = vec2wav_loop.main(vec2wav_loop.parse_args(args + ["--max_steps", "3"]), cfg=cfg)
    assert sorted(first.steps) == [0, 1, 2] and sorted(first.saves) == [2]
    assert list(first.validations) == [2]
    assert np.isfinite(first.validations[2]["mel_spec_error"])
    calls = fake_tensorboard[0].calls
    assert sum(1 for c in calls if c == ("add_scalar", "training/gen_loss_total")) == 3
    assert {c for c in calls if c[0] in ("add_audio", "add_figure")} == {
        ("add_audio", "generated/y_hat_0"), ("add_audio", "generated/y_hat_1"),
        ("add_figure", "generated/y_hat_spec_0"), ("add_figure", "generated/y_hat_spec_1")}
    do2 = torch.load(os.path.join(cfg.checkpoint_path, "do_00000002"), map_location="cpu",
                     weights_only=False)
    resumed = GANTrainer(cfg, device="cpu")
    vec2wav_loop.ckpt.load_vec2wav(os.path.join(cfg.checkpoint_path, "g_00000002"),
                                   os.path.join(cfg.checkpoint_path, "do_00000002"), resumed)
    state = resumed.state_dict()["optim_d"]["state"]
    assert do2["steps"] == 2 and do2["epoch"] == 0 and resumed.step_count == 3
    assert all(torch.equal(state[i][k], do2["optim_d"]["state"][i][k])
               for i in do2["optim_d"]["state"] for k in ("exp_avg", "exp_avg_sq"))
    del resumed, state, do2

    second = vec2wav_loop.main(vec2wav_loop.parse_args(args + ["--max_steps", "4"]), cfg=cfg)
    assert sorted(second.steps) == [3] and sorted(second.saves) == [3]
    assert sorted(os.listdir(cfg.checkpoint_path)) == sorted(
        f"{p}_{s:08d}" for p in ("g", "do") for s in (2, 3))
    # a rerun of the finished job resumes at step 4 = --max_steps: nothing to do
    before = _files_with_mtimes(cfg.checkpoint_path)
    third = vec2wav_loop.main(vec2wav_loop.parse_args(args + ["--max_steps", "4"]), cfg=cfg)
    assert third.steps == {} and third.saves == {} and third.validations == {}
    assert _files_with_mtimes(cfg.checkpoint_path) == before


# --- the command line and the device caches ---------------------------------------------

@pytest.mark.parametrize("cmd", ["train-text2vec", "train-vec2wav"])
def test_cli_train_subcommands(cmd, monkeypatch, tmp_path, jsonl_logger):
    """``cli train-text2vec`` / ``train-vec2wav`` take their loop's flags
    and ``--device``, run and write their checkpoint."""
    monkeypatch.chdir(REPO)
    if cmd == "train-text2vec":
        cfg = dataclasses.replace(load_config(Text2VecConfig, T2V_TINY), run_path=str(tmp_path),
                                  save_step=1)
        want = "checkpoint_1.pth.tar"
    else:
        cfg = dataclasses.replace(load_config(Vec2WavConfig, V2W_TINY), run_path=str(tmp_path))
        want = "g_00000000"
    path = str(tmp_path / "config.json")
    save_config(cfg, path)
    assert cli.main([cmd, "--config", path, "--max_steps", "1", "--device", "cpu"]) == 0
    assert want in os.listdir(cfg.checkpoint_path)
    assert cmd not in cli.NOT_PORTED


def test_cli_export_torch_names_the_port_files(capsys):
    assert cli.main(["export-torch"]) == 2
    assert "already the torch reference's files" in capsys.readouterr().err


@pytest.mark.parametrize("value,want", [("True", True), ("true", True), ("1", True),
                                        ("False", False), ("no", False), ("0", False)])
@pytest.mark.parametrize("loop,flag", [("text2vec", "--frozen_learning_rate"),
                                       ("vec2wav", "--fine_tuning")])
def test_loop_switches_parse_strictly(loop, flag, value, want):
    """The loops' true/false switches read "False" as off (JAX's
    ``type=bool`` reads any non-empty value as on) and refuse other words."""
    parse = {"text2vec": text2vec_loop, "vec2wav": vec2wav_loop}[loop].parse_args
    assert getattr(parse([flag, value]), flag[2:]) is want
    with pytest.raises(SystemExit):
        parse([flag, "maybe"])


@pytest.mark.parametrize("flag", ["--precompile", "--profile_dir"])
def test_text2vec_loop_refuses_jax_only_flags(flag):
    """JAX's ``--precompile`` and ``--profile_dir`` parse in the port as in
    JAX's loop (``tests/test_torch_loop_flags.py`` holds every option), and
    are refused where JAX's parser refuses them: ``--precompile`` takes no
    value, ``--profile_dir`` needs one."""
    bad, good, want = (([flag, "x"], [flag], True) if flag == "--precompile"
                       else ([flag], [flag, "x"], "x"))
    for parse in (text2vec_loop.parse_args, jt2v_loop.parse_args):
        with pytest.raises(SystemExit):
            parse(bad)
        assert getattr(parse(good), flag[2:]) == want


@pytest.mark.parametrize("loop", ["text2vec", "vec2wav"])
def test_device_resident_data_refused(loop, monkeypatch, tmp_path, jsonl_logger, capsys):
    """``device_resident_data=True`` is no longer refused: it passes
    ``check_ported`` and each loop trains from its device cache, the same
    batches in the same order, so its losses equal the host path's exactly.
    The GAN's windows are a whole utterance (segment_size 42 x 320, the
    demo's longest item), so both paths start each at frame 0 whatever
    their streams draw, and every demo wav is T x 320 samples long (no
    zero-fill case); one GAN step, two Text2Vec steps.  The GAN loop ignores
    the flag, with a message, without ``device_mel_target``."""
    monkeypatch.chdir(REPO)
    if loop == "text2vec":
        cfg = _t2v_cfg(tmp_path)
        run = lambda c: text2vec_loop.main(_t2v_args("--max_steps", "2"), cfg=c)  # noqa: E731
    else:
        cfg = dataclasses.replace(load_config(Vec2WavConfig, V2W_TINY), run_path=str(tmp_path),
                                  split=True, device_mel_target=True, segment_size=42 * 320,
                                  val_step=1000)
        run = lambda c: vec2wav_loop.main(vec2wav_loop.parse_args(  # noqa: E731
            ["--max_steps", "1", "--device", "cpu", "--num_workers", "0"]), cfg=c)
    on = dataclasses.replace(cfg, device_resident_data=True,
                             run_path=str(tmp_path / "device"))
    check_ported(on)
    host = run(cfg)
    capsys.readouterr()
    device = run(on)
    assert "device-resident dataset" in capsys.readouterr().out
    assert sorted(device.steps) == sorted(host.steps) and host.steps
    assert device.steps == host.steps
    if loop == "vec2wav":
        # the finished run resumes at --max_steps and trains nothing
        assert run(dataclasses.replace(on, device_mel_target=False)).steps == {}
        assert "device_resident_data ignored" in capsys.readouterr().out
