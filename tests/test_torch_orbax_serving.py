"""The JAX package's orbax variables in the port's serving, ``eval`` and
``recalibrate-bn``, on the CPU, read without JAX.

The Text2Vec and Generator variables of ``tests/fixtures/jax_orbax`` (as
the JAX ``recalibrate-bn`` writes them; ``tests/make_jax_orbax_fixtures.py``)
serve one request: the latents equal the JAX ``Synthesizer``'s committed
answer within atol 1e-4 (``tests/test_torch_checkpoint.py``'s latent
tolerance) and the waveform, through the same noise, the JAX
``Generator(fused=False)``'s within atol 2e-4 (ROADMAP.md's Generator
tolerance); the frame count is exact.  The fixture's training state
``checkpoint_1`` raises where serving and ``eval`` take variables, as the
JAX package's restore into variables does.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.infer import eval as t2v_eval
from wavthruvec_pytorch_tpu_torch.infer.synthesize import Synthesizer, init_import_models
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.models.vec2wav import Generator
from wavthruvec_pytorch_tpu_torch.text import TextFrontend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jax_orbax")
T2V_JSON = os.path.join(FIXTURES, "text2vec.json")
V2W_JSON = os.path.join(FIXTURES, "vec2wav.json")
T2V_VARS = os.path.join(FIXTURES, "t2v_variables")
GEN_VARS = os.path.join(FIXTURES, "gen_variables")


@pytest.fixture(scope="module")
def served():
    t2v_cfg = load_config(Text2VecConfig, T2V_JSON)
    v2w_cfg = load_config(Vec2WavConfig, V2W_JSON)
    t2v_state, gen_state = init_import_models(t2v_cfg, v2w_cfg, t2v_checkpoint=T2V_VARS,
                                              gen_checkpoint=GEN_VARS)
    frontend = TextFrontend.from_vocab_file(os.path.join(REPO, t2v_cfg.vocab_path))
    syn = Synthesizer(t2v_cfg, v2w_cfg, t2v_state, gen_state, frontend, device="cpu")
    return t2v_cfg, v2w_cfg, syn, np.load(os.path.join(FIXTURES, "expected.npz"))


def test_serving_matches_jax(served):
    t2v_cfg, v2w_cfg, syn, want = served
    text = str(want["text"])
    lat = syn.text_to_latents([text], want["ref"], max_frames=t2v_cfg.frame_buckets[-1])
    np.testing.assert_array_equal(lat["total_frames"], want["total_frames"])
    frames = int(want["total_frames"][0])
    got = lat["feat_postnet_output"][:, :frames]
    np.testing.assert_allclose(got, want["latents"], atol=1e-4)
    wav = syn.latents_to_wav(lat["feat_postnet_output"], want["spk"], noise=want["noise"])
    n = frames * v2w_cfg.total_upsample
    assert want["wav"].shape == (1, n)
    np.testing.assert_allclose(wav[:, :n], want["wav"], atol=2e-4)
    print(f"latents max |port - JAX| {np.abs(got - want['latents']).max():.3g}, "
          f"wav {np.abs(wav[:, :n] - want['wav']).max():.3g}")


def test_cli_synthesize_from_orbax_variables(tmp_path, served):
    t2v_cfg, v2w_cfg, _, want = served
    np.save(tmp_path / "ref.npy", want["ref"][0])
    np.save(tmp_path / "spk.npy", want["spk"][0])
    out = tmp_path / "out"
    assert cli.main(["synthesize", "--text", str(want["text"]), "--ref_npy",
                     str(tmp_path / "ref.npy"), "--spk_emb", str(tmp_path / "spk.npy"),
                     "--t2v_config", T2V_JSON, "--v2w_config", V2W_JSON, "--t2v_checkpoint",
                     T2V_VARS, "--gen_checkpoint", GEN_VARS, "--out_dir", str(out),
                     "--device", "cpu"]) == 0
    from scipy.io import wavfile

    sr, wav = wavfile.read(out / "synth_0.wav")
    assert sr == v2w_cfg.sampling_rate
    assert len(wav) == int(want["total_frames"][0]) * v2w_cfg.total_upsample


def test_training_state_raises_where_variables_are_taken(tmp_path):
    """Serving and ``eval`` take variables: the training state raises, as
    the JAX package's ``restore_checkpoint(path, variables)`` does (its
    ``eval`` points at the loop's ``checkpoint_{step}``, a whole
    ``T2VTrainState``).  ``eval`` takes the directory before the
    ``.pth.tar`` of the same step, as JAX does."""
    t2v_cfg = load_config(Text2VecConfig, T2V_JSON)
    v2w_cfg = load_config(Vec2WavConfig, V2W_JSON)
    state = os.path.join(FIXTURES, "checkpoint_1")
    with pytest.raises(ValueError, match="training state.*export-torch"):
        init_import_models(t2v_cfg, v2w_cfg, t2v_checkpoint=state)
    with pytest.raises(ValueError, match="holds t2v_variables"):
        init_import_models(t2v_cfg, v2w_cfg, gen_checkpoint=T2V_VARS)
    shutil.copytree(state, tmp_path / "checkpoint_1")
    with pytest.raises(ValueError, match="training state"):
        t2v_eval.load_model(t2v_cfg, str(tmp_path), 1, device="cpu")

    shutil.copytree(T2V_VARS, tmp_path / "checkpoint_3")
    torch.manual_seed(9)
    torch.save({"model": Text2Vec(t2v_cfg, device="cpu").state_dict()},
               tmp_path / "checkpoint_3.pth.tar")
    model = t2v_eval.load_model(t2v_cfg, str(tmp_path), 3, device="cpu")
    want = ckpt.load_torch_state_dict(T2V_VARS, key="model", cfg=t2v_cfg)
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert ckpt.orbax_layout(GEN_VARS) == "gen_variables"


@pytest.mark.parametrize("stage", ["t2v", "generator"])
def test_recalibrate_bn_takes_orbax_variables(tmp_path, stage):
    """``recalibrate-bn`` on an orbax variables directory writes the torch
    reference's file (``checkpoint_0.pth.tar`` / ``g_00000000``), which
    loads strictly and holds statistics recalibrated from the input's."""
    t2v_cfg = load_config(Text2VecConfig, T2V_JSON)
    v2w_cfg = load_config(Vec2WavConfig, V2W_JSON)
    rng = np.random.default_rng(6)
    symbols = TextFrontend.from_vocab_file(os.path.join(REPO, t2v_cfg.vocab_path)).symbols
    rows = []
    for i in range(3):
        np.save(tmp_path / f"u{i}.npy",
                (rng.standard_normal((1, 120, t2v_cfg.n_feat_dim)) * 0.5).astype(np.float32))
        rows.append(f"u{i}.npy|{symbols[3 + i:9 + i]}|spk0")
    (tmp_path / "list.txt").write_text("\n".join(rows) + "\n", encoding="utf-8")
    os.makedirs(tmp_path / "spk")
    np.save(tmp_path / "spk" / "spk0.npy", rng.standard_normal(v2w_cfg.spk_dim).astype(np.float32))
    common = ["recalibrate-bn", "--filelist", str(tmp_path / "list.txt"), "--feat_root",
              str(tmp_path), "--out", str(tmp_path / "out"), "--device", "cpu"]
    if stage == "t2v":
        args = ["--t2v_checkpoint", T2V_VARS, "--config", T2V_JSON]
        name, key, model = "checkpoint_0.pth.tar", "model", Text2Vec(t2v_cfg, device="cpu")
        src = ckpt.load_torch_state_dict(T2V_VARS, key="model", cfg=t2v_cfg)
    else:
        args = ["--generator_checkpoint", GEN_VARS, "--config", V2W_JSON, "--spk_emb_dir",
                str(tmp_path / "spk"), "--gen_frames", "100"]
        name, key, model = "g_00000000", "generator", Generator(v2w_cfg, device="cpu")
        src = ckpt.load_torch_state_dict(GEN_VARS, key="generator", cfg=v2w_cfg)
    assert cli.main(common + args) == 0
    obj = torch.load(tmp_path / "out" / name, map_location="cpu", weights_only=False)
    model.load_state_dict(obj[key], strict=True)
    stats = [k for k in src if k.endswith("running_mean")]
    assert stats and any(not torch.equal(obj[key][k], src[k]) for k in stats)
    assert all(torch.equal(obj[key][k], src[k]) for k in src
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
