"""The training loops' command lines against the JAX loops', and the Text2Vec
loop's ``--profile_dir`` and ``--precompile`` on the CPU.

Every option of JAX's ``text2vec_loop.parse_args`` and
``vec2wav_loop.parse_args`` must parse in the port's and land on the same
attribute with the same default; the port's ``--device`` and
``--dist_backend`` are its own.  ``--profile_dir`` traces the steps JAX's loop
traces (iterations 3 to 8) with ``torch.profiler``.
"""

import argparse
import dataclasses
import json
import os
import sys
from unittest import mock

import pytest

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_checkpoint_io import one_torch_thread  # noqa: F401 (autouse)
from wavthruvec_pytorch_tpu.train import text2vec_loop as jt2v_loop
from wavthruvec_pytorch_tpu.train import vec2wav_loop as jv2w_loop
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config, repo_path
from wavthruvec_pytorch_tpu_torch.train import text2vec_loop, vec2wav_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2V_TINY = os.path.join("data", "demo", "text2vec_tiny.json")
LOOPS = {"text2vec": (jt2v_loop, text2vec_loop), "vec2wav": (jv2w_loop, vec2wav_loop)}
PORT_ONLY = {"--device", "--dist_backend"}


def _parser(parse_args) -> argparse.ArgumentParser:
    """The parser a loop's ``parse_args`` builds."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *args, **kwargs):
        seen.append(self)
        return parse(self, *args, **kwargs)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        parse_args([])
    return seen[-1]


def _options(parser) -> dict:
    return {opt: act for act in parser._actions for opt in act.option_strings
            if opt not in ("-h", "--help")}


def _argv_for(actions) -> list:
    """A command line that sets every action to a value other than its
    default."""
    argv = []
    for act in {id(a): a for a in actions}.values():
        opt = act.option_strings[0]
        if isinstance(act, argparse.BooleanOptionalAction):
            argv.append(f"--no-{opt[2:]}" if act.default else opt)
        elif act.nargs == 0:  # store_true
            argv.append(opt)
        elif act.type is int:
            argv += [opt, "7"]
        elif act.type is float:
            argv += [opt, "0.5"]
        elif act.type is bool:  # JAX's switches; the port's parse_bool reads "true" alike
            argv += [opt, "true"]
        else:
            argv += [opt, f"value_of_{act.dest}"]
    return argv


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_loop_options_match_jax(loop):
    """Each option of the JAX loop's parser is an option of the port's with
    the same ``dest`` and default; the port adds only ``--device`` and
    ``--dist_backend``; a command line giving every JAX option a value lands
    on equal attributes in both."""
    jax_loop, port_loop = LOOPS[loop]
    jopts, topts = _options(_parser(jax_loop.parse_args)), _options(_parser(port_loop.parse_args))
    assert set(topts) - set(jopts) == PORT_ONLY
    for opt, act in jopts.items():
        assert opt in topts, f"{loop}: {opt} is not an option of the port"
        assert (topts[opt].dest, topts[opt].default) == (act.dest, act.default), opt
    argv = _argv_for(jopts.values())
    jns, tns = jax_loop.parse_args(argv), port_loop.parse_args(argv)
    for dest in {act.dest for act in jopts.values()}:
        assert getattr(tns, dest) == getattr(jns, dest), dest


def test_cli_takes_the_jax_loops_flags(monkeypatch):
    """``cli train-vec2wav`` with JAX's ``--group_name``, ``--input_wavs_dir``
    and ``--validation_interval``, and ``cli train-text2vec`` with
    ``--profile_dir`` and ``--no-precompile``, reach their loop's ``main``
    (they exited with status 2 before)."""
    got = {}
    monkeypatch.setattr(vec2wav_loop, "main", lambda args: got.setdefault("v2w", args))
    monkeypatch.setattr(text2vec_loop, "main", lambda args: got.setdefault("t2v", args))
    assert cli.main(["train-vec2wav", "--group_name", "x", "--input_wavs_dir", "y",
                     "--validation_interval", "5", "--max_steps", "1", "--device", "cpu"]) == 0
    v2w = got["v2w"]
    assert (v2w.group_name, v2w.input_wavs_dir, v2w.validation_interval) == ("x", "y", 5)
    assert cli.main(["train-text2vec", "--profile_dir", "trace", "--no-precompile"]) == 0
    assert (got["t2v"].profile_dir, got["t2v"].precompile) == ("trace", False)


def _tiny_cfg(tmp_path):
    """The tiny demo config, 3 epochs of 4 steps, no saves or text logs."""
    return dataclasses.replace(load_config(Text2VecConfig, T2V_TINY), run_path=str(tmp_path),
                               epochs=3, save_step=1000, log_step=1000)


def test_profile_dir_traces_iterations_3_to_8(monkeypatch, tmp_path, capsys):
    """The CPU loop with ``--profile_dir`` takes 9 steps on the demo corpus
    and writes one Chrome trace whose step spans are exactly those JAX's loop
    traces (the steps starting at iterations 3 to 8) and which names the
    steps' aten ops; ``--precompile`` (the default) says there is nothing to
    build on the CPU."""
    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    prof_dir = tmp_path / "prof"
    args = text2vec_loop.parse_args(["--device", "cpu", "--max_steps", "9", "--profile_dir",
                                     str(prof_dir)])
    record = text2vec_loop.main(args, cfg=_tiny_cfg(tmp_path))
    assert sorted(record.steps) == list(range(1, 10))
    out = capsys.readouterr().out
    assert out.count("precompile: nothing to build on the CPU") == 1
    assert os.listdir(prof_dir) == ["text2vec_rank0.pt.trace.json"]
    with open(prof_dir / "text2vec_rank0.pt.trace.json", encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    spans = sorted(int(n.rsplit(" ", 1)[1]) for n in names
                   if n.startswith(text2vec_loop.PROFILE_SPAN))
    assert spans == list(range(text2vec_loop.PROFILE_START, text2vec_loop.PROFILE_STOP + 1))
    for op in ("aten::addmm", "aten::convolution", "aten::softmax"):
        assert op in names, op


@pytest.mark.parametrize("flag", ["--precompile", "--no-precompile"])
def test_precompile_runs_on_cpu(flag, monkeypatch, tmp_path, capsys):
    """Both ``--precompile`` and ``--no-precompile`` train on the CPU; only the
    former prints its line.  On a card it builds the libraries the step
    launches: the BiGRU's forward and backward and MAS's, and flash
    attention's where the flash gate can pass at a bucket (the long-bucket
    config; not the demo config, which has no flash)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    args = text2vec_loop.parse_args(["--device", "cpu", "--max_steps", "1", flag])
    assert args.precompile == (flag == "--precompile")
    record = text2vec_loop.main(args, cfg=_tiny_cfg(tmp_path))
    assert sorted(record.steps) == [1]
    said = "precompile: nothing to build on the CPU" in capsys.readouterr().out
    assert said == (flag == "--precompile")
    demo = load_config(Text2VecConfig, T2V_TINY)
    assert text2vec_loop.step_kernels(demo) == ["gru_fwd", "gru_bwd", "mas"]
    long_cfg = load_config(Text2VecConfig, repo_path("artifacts", "flash_longbucket", "flash",
                                                     "longbucket", "config.json"))
    assert text2vec_loop.step_kernels(long_cfg) == ["gru_fwd", "gru_bwd", "mas", "flash_attn"]
    short = dataclasses.replace(long_cfg, text_buckets=(64,), frame_buckets=(200,))
    assert text2vec_loop.step_kernels(short) == ["gru_fwd", "gru_bwd", "mas"]
