"""BatchNorm recalibration in the port (``infer/recalibrate.py`` and ``cli
recalibrate-bn``) against the JAX package's on the CPU.

The functions: the same weights (carried by ``weights.py``) and batches
through both packages' recalibration; every running statistic within rtol
1e-5.  The command: the port's files, read back by the JAX package's
``import_text2vec`` / ``import_vec2wav_generator``, hold the statistics of
JAX's recalibration from the same input file, data and noise (rtol 1e-5),
and every other entry of the input file unchanged.  The BatchNorms' inputs
do not pass the CBHG's BiGRU, so JAX's ``gru_impl="scan"`` serves.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_models import T2V_SMALL, V2W_SMALL
from tests.test_torch_train import _randomize_stats
from wavthruvec_pytorch_tpu import checkpoint as jckpt
from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.infer import recalibrate as jrecal
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.models.vec2wav import Generator as JGenerator
from wavthruvec_pytorch_tpu.text import TextFrontend as JFrontend
from wavthruvec_pytorch_tpu_torch import cli, weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, repo_path
from wavthruvec_pytorch_tpu_torch.infer import recalibrate
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

T2V_TINY = repo_path("data", "demo", "text2vec_tiny.json")
V2W_TINY = repo_path("data", "demo", "vec2wav_tiny.json")
FEATS = repo_path("data", "demo", "w2v_feat_tiny")
FILELIST = repo_path("data", "demo", "enc_train.txt")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _assert_stats(got_sd, want_sd, rtol=1e-5):
    """Every running mean and variance within ``rtol`` of JAX's, element by
    element."""
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(np.asarray(got_sd[k]), np.asarray(want_sd[k]), rtol=rtol,
                                   atol=1e-6, err_msg=k)


def _assert_stats_scaled(got_sd, want_sd, tol):
    """Every running mean and variance within ``tol`` of the largest entry of
    its tensor."""
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        want = np.asarray(want_sd[k])
        err = np.abs(np.asarray(got_sd[k]) - want).max() / np.abs(want).max()
        assert err <= tol, (k, err)


def test_momentum_is_the_layers():
    assert recalibrate._bn_momentum() == BatchNorm.momentum == jrecal._bn_momentum() == 0.9


def _t2v_batches(cfg, seed, n=2, B=8):
    """``n`` batches of B texts of 5-15 ids padded to 16, and 30-frame clips."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        seq = np.zeros((B, 16), np.int32)
        for b in range(B):
            k = int(rng.integers(5, 16))
            seq[b, :k] = rng.integers(1, cfg.vocab_size, k)
        pos = np.where(seq != 0, np.arange(1, 17)[None], 0).astype(np.int32)
        out.append((seq, pos, rng.standard_normal((B, 30, cfg.n_feat_dim)).astype(np.float32)))
    return out


def test_recalibrate_text2vec_matches_jax():
    """``recalibrate_text2vec_bn`` == JAX's over two batches of eight random
    clips: ECAPA's and the CBHG's running statistics within 1e-4 of each
    tensor's largest entry (the CBHG's sit behind the whole decoder, whose
    f32 sums XLA and PyTorch take in other orders: up to 4e-5 measured; the
    command's test below holds the demo data's at rtol 1e-5 an element);
    the parameters untouched."""
    jcfg = dataclasses.replace(T2V_SMALL, frame_buckets=(64,), text_buckets=(16,),
                               learn_alignments=False)  # the infer branch has no attention
    cfg = _port_cfg(Text2VecConfig, jcfg)
    model = JText2Vec(jcfg)
    batches = _t2v_batches(cfg, 0)
    seq, pos, feat = (jnp.asarray(a) for a in batches[0])
    variables = _np(model.init({"params": jax.random.PRNGKey(0)}, seq, pos, feat, 64,
                               method=JText2Vec.infer))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], 1)
    want = jrecal.recalibrate_text2vec_bn(model, variables, batches, max_frames=64)
    port = Text2Vec(cfg, device="cpu")
    port.load_state_dict(weights.text2vec_state_dict(variables, jcfg), strict=True)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    assert recalibrate.recalibrate_text2vec_bn(port, batches, max_frames=64) is port
    assert port.training and all(m.training for m in port.modules())  # its modes kept
    _assert_stats_scaled(port.state_dict(), weights.text2vec_state_dict(_np(want), jcfg), 1e-4)
    for k, v in port.state_dict().items():
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, before[k]), k


def test_recalibrate_generator_matches_jax():
    """``recalibrate_generator_bn`` == JAX's (train mode, the spectral
    vectors' update thrown away) over two batches, the same noise."""
    cfg = _port_cfg(Vec2WavConfig, V2W_SMALL)
    jgen = JGenerator(V2W_SMALL)
    rng = np.random.default_rng(2)
    batches = [(rng.standard_normal((3, 12, cfg.n_feat_dim)).astype(np.float32),
                rng.standard_normal((3, cfg.spk_dim)).astype(np.float32),
                rng.standard_normal((3, cfg.noise_dim)).astype(np.float32)) for _ in range(2)]
    variables = _np(jgen.init(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in batches[0]),
                              train=False))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], 3)
    want = jrecal.recalibrate_generator_bn(jgen, variables, batches)
    gen = Generator(cfg, device="cpu")
    gen.load_state_dict(weights.generator_state_dict(variables, cfg), strict=True)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    recalibrate.recalibrate_generator_bn(gen, batches)
    assert not any(m.training for m in gen.modules())  # the serving Generator's eval mode
    _assert_stats(gen.state_dict(), weights.generator_state_dict(_np(want), cfg))
    for k, v in gen.state_dict().items():
        if not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, before[k]), k  # weight_u / weight_v included


def test_no_batches_raises():
    gen = Generator(_port_cfg(Vec2WavConfig, V2W_SMALL), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        recalibrate.recalibrate_generator_bn(gen, [])


def _rows():
    return cli._parse_filelist(FILELIST, 128)


def test_cli_text2vec(tmp_path):
    """``recalibrate-bn --t2v_checkpoint``: JAX's import of the written file
    holds JAX's recalibrated statistics; the optimizer, learning rate and
    epoch are carried over."""
    from wavthruvec_pytorch_tpu.config import load_config as jload

    cfg = Text2VecConfig(**{k: v for k, v in vars(jload(JT2V, T2V_TINY)).items()})
    with torch.random.fork_rng():
        torch.manual_seed(5)
        model = Text2Vec(cfg, device="cpu")
    src = tmp_path / "in" / "checkpoint_7.pth.tar"
    src.parent.mkdir()
    extra = {"optimizer": {"state": {}, "param_groups": [{"lr": 0.01}]}, "learning_rate": 0.01,
             "epoch": 3}
    torch.save({"model": model.state_dict(), **extra}, src)
    rc = cli.main(["recalibrate-bn", "--t2v_checkpoint", str(src), "--filelist", FILELIST,
                   "--feat_root", FEATS, "--config", T2V_TINY, "--batch_size", "5",
                   "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    out = torch.load(tmp_path / "out" / "checkpoint_7.pth.tar", weights_only=False)
    assert {k: out[k] for k in extra} == extra

    jcfg = jload(JT2V, T2V_TINY)
    sd = {k: v.numpy() for k, v in torch.load(src, weights_only=False)["model"].items()}
    jvars = jckpt.import_text2vec(sd, jcfg)
    items = [(text, np.load(os.path.join(FEATS, npy)).squeeze().astype(np.float32))
             for npy, text, _ in _rows()]
    batches = jrecal.text2vec_calibration_batches(JFrontend.from_vocab_file(jcfg.vocab_path),
                                                  jcfg, items, batch_size=5)
    want = jrecal.recalibrate_text2vec_bn(JText2Vec(jcfg), jvars, batches,
                                          max_frames=jcfg.frame_buckets[-1])
    got = jckpt.import_text2vec({k: v.numpy() for k, v in out["model"].items()}, jcfg)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                              jax.tree_util.tree_flatten_with_path(want["batch_stats"])[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))
    np.testing.assert_array_equal(
        np.asarray(got["params"]["WVF_linear"]["Dense_0"]["kernel"]),
        np.asarray(jvars["params"]["WVF_linear"]["Dense_0"]["kernel"]))


def test_cli_generator(tmp_path):
    """``recalibrate-bn --generator_checkpoint``: JAX's import of the written
    ``g_`` file holds JAX's recalibrated Conditional-BN statistics for the
    same rows and noise (the port's seeded CPU ``torch.Generator`` draws,
    handed to JAX)."""
    from wavthruvec_pytorch_tpu.config import load_config as jload
    from wavthruvec_pytorch_tpu.data.vocoder_data import load_spk_emb

    jcfg = jload(JV2W, V2W_TINY)
    cfg = _port_cfg(Vec2WavConfig, jcfg)
    with torch.random.fork_rng():
        torch.manual_seed(6)
        gen = Generator(cfg, device="cpu", fused=False)
    src = tmp_path / "g_00000012"
    torch.save({"generator": gen.state_dict()}, src)
    spk_dir = repo_path("data", "demo", "spk_emb")
    rc = cli.main(["recalibrate-bn", "--generator_checkpoint", str(src), "--filelist", FILELIST,
                   "--feat_root", FEATS, "--config", V2W_TINY, "--batch_size", "4",
                   "--gen_frames", "20", "--spk_emb_dir", spk_dir, "--seed", "9",
                   "--out", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0
    out = torch.load(tmp_path / "out" / "g_00000012", weights_only=False)
    assert list(out) == ["generator"]

    keep = [(np.load(os.path.join(FEATS, npy)).squeeze()[:20].astype(np.float32),
             load_spk_emb(os.path.join(spk_dir, spk + ".npy")).reshape(-1))
            for npy, _, spk in _rows()
            if np.load(os.path.join(FEATS, npy)).shape[1] >= 20]
    noise = torch.Generator().manual_seed(9)
    batches = [(np.stack([lat for lat, _ in keep[i: i + 4]]),
                np.stack([e for _, e in keep[i: i + 4]]).astype(np.float32),
                torch.randn((len(keep[i: i + 4]), cfg.noise_dim), generator=noise).numpy())
               for i in range(0, len(keep), 4)]
    jvars = jckpt.import_vec2wav_generator(
        {k: v.numpy() for k, v in gen.state_dict().items()}, jcfg)
    want = jrecal.recalibrate_generator_bn(JGenerator(jcfg), jvars, batches)
    got = jckpt.import_vec2wav_generator({k: v.numpy() for k, v in out["generator"].items()},
                                         jcfg)
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                              jax.tree_util.tree_flatten_with_path(want["batch_stats"])[0]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got["spectral"])[0],
                              jax.tree_util.tree_flatten_with_path(jvars["spectral"])[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(p))


@pytest.mark.parametrize("text,match", [("a.npy|text\n", ":1: expected 'npy|text|spk'"),
                                        ("a.npy|x|s\n\nb.npy\n", ":3: expected")])
def test_parse_filelist_errors(tmp_path, text, match):
    p = tmp_path / "list.txt"
    p.write_text(text, encoding="utf-8")
    with pytest.raises(ValueError, match=match):
        cli._parse_filelist(str(p), 10)


def test_parse_filelist_keeps_bars_in_text(tmp_path):
    p = tmp_path / "list.txt"
    p.write_text("a.npy|x|y|z|spk\n\nb.npy|t|s\nc.npy|u|s\n", encoding="utf-8")
    assert cli._parse_filelist(str(p), 2) == [("a.npy", "x|y|z", "spk"), ("b.npy", "t", "s")]


def test_cli_refuses_overwriting_its_input(tmp_path):
    src = tmp_path / "g_00000001"
    src.write_bytes(b"")
    with pytest.raises(SystemExit):
        cli.main(["recalibrate-bn", "--generator_checkpoint", str(src), "--filelist", FILELIST,
                  "--out", str(tmp_path), "--device", "cpu"])
