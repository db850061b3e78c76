"""Loading the torch reference's checkpoint files into the port
(``checkpoint.py``, ``infer.synthesize.init_import_models``) and the port's
command line (``cli.py``), on the CPU.

Files in the reference format are written by the JAX package's own writers
(``save_reference_text2vec``, ``save_reference_vec2wav``) from the weights
of ``tests/test_torch_synthesize.py``'s model: the port loads them with
``strict=True`` and synthesizes exactly (bit for bit) what it synthesizes
from the same weights handed over in memory by ``weights.py``.  The command
line runs the tiny demo configs (``data/demo/*_tiny.json``) with seeded
random weights: its streamed audio equals its batched audio within 2e-5
(the streaming tolerance of ``tests/test_torch_streaming.py``).
"""

import io
import os
import re
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_synthesize import SYMBOLS, T2V, V2W, models  # noqa: F401  (fixture)
from wavthruvec_pytorch_tpu import checkpoint as jckpt
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config, repo_path
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, init_import_models
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

FIXTURES = repo_path("tests", "fixtures", "jax_orbax")
# the JAX command line's subcommands, as its main() dispatches them
with open(repo_path("wavthruvec_pytorch_tpu", "cli.py"), encoding="utf-8") as _f:
    JAX_SUBCOMMANDS = sorted(set(re.findall(r'cmd == "([a-z0-9-]+)"', _f.read())))

TINY = ["--t2v_config", repo_path("data", "demo", "text2vec_tiny.json"),
        "--v2w_config", repo_path("data", "demo", "vec2wav_tiny.json"), "--device", "cpu"]


def test_reference_files_load_strict_and_give_the_same_wav(tmp_path, models):
    jt2v_cfg, jv2w_cfg, t2v_vars, gen_vars, t2v_sd, gen_sd = models
    t2v_file = str(tmp_path / "checkpoint_7.pth.tar")
    jckpt.save_reference_text2vec(t2v_file, t2v_vars, jt2v_cfg, epoch=3)
    jckpt.save_reference_vec2wav(str(tmp_path), 7, gen_vars, jv2w_cfg)
    gen_file = str(tmp_path / "g_00000007")
    assert os.path.isfile(gen_file)
    t2v_cfg, v2w_cfg = Text2VecConfig(**T2V), Vec2WavConfig(**V2W)
    t2v_state, gen_state = init_import_models(t2v_cfg, v2w_cfg, t2v_checkpoint=t2v_file,
                                              gen_checkpoint=gen_file)
    for got, want in ((t2v_state, t2v_sd), (gen_state, gen_sd)):
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(0)
    ref = (rng.standard_normal((1, 21, 128)) * 0.5).astype(np.float32)
    spk = rng.standard_normal((1, 8)).astype(np.float32)
    wavs = []
    for t2v, gen in ((t2v_state, gen_state), (t2v_sd, gen_sd)):
        syn = Synthesizer(t2v_cfg, v2w_cfg, t2v, gen, TextFrontend(SYMBOLS), device="cpu")
        wavs.append(syn.synthesize(["hij klmnopq"], ref, spk, alpha=1.3, seed=5))
    np.testing.assert_array_equal(wavs[0][0], wavs[1][0])
    np.testing.assert_array_equal(wavs[0][1], wavs[1][1])
    assert wavs[0][1][0] > 0


def test_orbax_directory_raises(tmp_path):
    """An orbax directory of the JAX package: Text2Vec and Generator
    variables load (those of ``tests/fixtures/jax_orbax``, strictly into the
    port's models), a training state raises as the JAX package's restore
    into variables does, naming the port's ``export-torch``, and a directory
    that is no orbax checkpoint raises."""
    t2v_cfg = load_config(Text2VecConfig, os.path.join(FIXTURES, "text2vec.json"))
    v2w_cfg = load_config(Vec2WavConfig, os.path.join(FIXTURES, "vec2wav.json"))
    t2v_state, gen_state = init_import_models(
        t2v_cfg, v2w_cfg, t2v_checkpoint=os.path.join(FIXTURES, "t2v_variables"),
        gen_checkpoint=os.path.join(FIXTURES, "gen_variables"))
    Text2Vec(t2v_cfg, device="cpu").load_state_dict(t2v_state, strict=True)
    Generator(v2w_cfg, device="cpu").load_state_dict(gen_state, strict=True)
    train_state = os.path.join(FIXTURES, "checkpoint_1")
    for kw in ({"t2v_checkpoint": train_state}, {"gen_checkpoint": train_state}):
        with pytest.raises(ValueError, match="training state.*export-torch"):
            init_import_models(t2v_cfg, v2w_cfg, **kw)
    with pytest.raises(ValueError, match="_METADATA"):
        init_import_models(t2v_cfg, v2w_cfg, t2v_checkpoint=str(tmp_path))


def test_random_weights_are_seeded():
    """Without checkpoints each model takes weights seeded 0, made on the
    CPU, and the caller's random stream is left as it was."""
    t2v_cfg, v2w_cfg = Text2VecConfig(**T2V), Vec2WavConfig(**V2W)
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    a = init_import_models(t2v_cfg, v2w_cfg)
    assert torch.equal(torch.rand(3), before)
    b = init_import_models(t2v_cfg, v2w_cfg)
    for i in range(2):
        assert all(torch.equal(a[i][k], b[i][k]) for k in a[i])
        assert all(v.device.type == "cpu" for v in a[i].values())
    folded = init_import_models(t2v_cfg, v2w_cfg, folded=True)[1]
    assert not torch.equal(folded["conv_pre.weight_v"], a[1]["conv_pre.weight_v"])
    torch.testing.assert_close(folded["conv_pre.weight_g"], a[1]["conv_pre.weight_g"])


def _text() -> str:
    symbols = TextFrontend.from_vocab_file(repo_path("data", "demo", "vocab.txt")).symbols
    return symbols[3:12]


def _synthesize(tmp_path, name, *extra):
    out = tmp_path / name
    rc = cli.main(["synthesize", "--text", _text(), "--text", _text()[:4],
                   "--ref_npy", repo_path("data", "demo", "w2v_feat_tiny", "train", "SSB0000",
                                          "u0.npy"),
                   "--spk_emb", repo_path("data", "demo", "spk_emb", "SSB0000.npy"),
                   "--alpha", "3.0", "--out_dir", str(out), *TINY, *extra])
    assert rc == 0
    wavs = [wavfile.read(out / f"synth_{i}.wav") for i in range(2)]
    assert all(sr == 16000 and w.dtype == np.float32 and w.shape[0] > 0 for sr, w in wavs)
    return [w for _, w in wavs]


def test_cli_synthesize_cpu_writes_wavs(tmp_path):
    full = _synthesize(tmp_path, "full")
    streamed = _synthesize(tmp_path, "stream", "--stream", "--chunk_frames", "16")
    for a, b in zip(full, streamed):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-5)
    bf16 = _synthesize(tmp_path, "bf16", "--gen_precision", "bf16", "--folded")
    assert [w.shape for w in bf16] == [w.shape for w in full]
    assert all(np.isfinite(w).all() for w in bf16)


def test_cli_serve_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"{_text()}\nSSB0001|{_text()[:3]}\nQUIT\n"))
    rc = cli.main(["serve", "--spk_emb_dir", repo_path("data", "demo", "spk_emb"),
                   "--ref_feat_dir", repo_path("data", "demo", "w2v_feat_tiny", "train"),
                   "--out_dir", str(tmp_path), "--max_batch", "4", "--coalesce_wait_ms", "2000",
                   "--alpha", "3.0", *TINY])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and [line.split()[0] for line in lines] == ["OK", "OK", "served"]
    assert all("batched=2" in line for line in lines[:2])
    assert sorted(os.listdir(tmp_path)) == ["utt_000000.wav", "utt_000001.wav"]


def test_cli_gru_impl_scan_synthesizes(tmp_path, monkeypatch):
    """``--gru_impl scan`` (the JAX package's default: the BiGRU in f32)
    synthesizes, and on a reference-format checkpoint written by the JAX
    package its latents match the JAX Synthesizer's on the same texts and
    reference: frame counts exact, latents atol 1e-4 (f32 on both sides,
    sums in another order)."""
    import jax
    import jax.numpy as jnp

    from tests.test_models import _t2v_batch
    from tests.test_torch_train import _init_params, _randomize_stats
    from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
    from wavthruvec_pytorch_tpu.config import load_config as jload_config
    from wavthruvec_pytorch_tpu.infer.synthesize import Synthesizer as JSynthesizer
    from wavthruvec_pytorch_tpu.models import Text2Vec as JText2Vec
    from wavthruvec_pytorch_tpu.text import TextFrontend as JTextFrontend

    jcfg = jload_config(JT2V, repo_path("data", "demo", "text2vec_tiny.json"))
    src_seq, src_pos, feat, in_lens, out_lens, feat_pos, prior = _t2v_batch(jcfg)
    shapes = jax.eval_shape(lambda key: JText2Vec(jcfg).init(
        {"params": key, "dropout": key}, src_seq, src_pos, feat, in_lens, out_lens, feat_pos,
        attn_prior=prior, deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    variables = {"params": _init_params(shapes["params"], 2),
                 "batch_stats": _randomize_stats(shapes["batch_stats"], 2)}
    t2v_file = str(tmp_path / "checkpoint_0.pth.tar")
    jckpt.save_reference_text2vec(t2v_file, variables, jcfg)

    seen = []
    latents = Synthesizer._latents

    def record(self, *args, **kwargs):
        out, lengths = latents(self, *args, **kwargs)
        assert self.t2v.postnet.gru.gru_impl == "scan"
        seen.append({k: out[k].detach().cpu().numpy()
                     for k in ("feat_postnet_output", "total_frames")})
        return out, lengths

    monkeypatch.setattr(Synthesizer, "_latents", record)
    wavs = _synthesize(tmp_path, "scan", "--gru_impl", "scan", "--t2v_checkpoint", t2v_file)
    assert len(seen) == 1 and all(np.isfinite(w).all() for w in wavs)
    texts = [_text(), _text()[:4]]
    ref = np.load(repo_path("data", "demo", "w2v_feat_tiny", "train", "SSB0000", "u0.npy"))
    ref = np.repeat(ref.squeeze()[None].astype(np.float32), 2, axis=0)
    jsyn = JSynthesizer(jcfg, None, variables, None,
                        JTextFrontend.from_vocab_file(repo_path("data", "demo", "vocab.txt")))
    want = jsyn.text_to_latents(texts, ref, alpha=3.0)
    np.testing.assert_array_equal(seen[0]["total_frames"], want["total_frames"])
    assert want["total_frames"].min() > 0
    got, ref_lat = seen[0]["feat_postnet_output"], want["feat_postnet_output"]
    print(f"--gru_impl scan latents: max |port - JAX| {np.abs(got - ref_lat).max():.3g}")
    np.testing.assert_allclose(got, ref_lat, atol=1e-4)


@pytest.mark.parametrize("cmd", JAX_SUBCOMMANDS)
def test_cli_unported_subcommands_exit_nonzero(cmd, capsys):
    """No subcommand of the JAX command line is left unported (the port's
    table of unported ones is gone): the port's ``cli.main`` dispatches each
    of them, whose ``--help`` prints its flags and exits with 0, where an
    unknown command returns 1."""
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_cli_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """Without ``--device`` the command line serves on the card, and raises
    where PyTorch sees none: it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["serve", "--spk_emb_dir", repo_path("data", "demo", "spk_emb"),
                  "--out_dir", str(tmp_path), *TINY[:4]])
