"""The JAX package's orbax training states in the port, on the CPU: the
loops' resume and ``export-torch``.

* Text2Vec: the committed ``T2VTrainState`` ``tests/fixtures/jax_orbax/
  checkpoint_1`` (one JAX step taken, its learning rate set to 0.005 in
  the optimizer state) resumes into the port's ``Text2VecTrainer``: step,
  learning rate and LAMB moments carried.  One step on the committed batch
  then matches the JAX package's next step (``expected.npz``, written by
  ``tests/make_jax_orbax_fixtures.py``) at the port's step-parity
  tolerance (``tests/test_torch_train.py::test_step_running_stats_and_update``):
  parameters within atol 1e-5 in at least 99.9% of the elements, the rest
  within twice the tensor's largest step; running statistics atol 1e-5.
* Text2Vec with ECAPA: the fixture's config has no ECAPA (its fixed
  1536/4608 widths do not fit the fixtures' size), so a ``T2VTrainState``
  at ``data/demo/text2vec_tiny.json`` (ECAPA on), in the structure of the
  JAX package's ``init_state`` with patterned weights and LAMB moments, is
  written here and resumes with every weight and moment equal to what the
  JAX package's own torch exporter (``export_text2vec``, the mapping of
  JAX ``export-torch``) makes of the state's params, ``mu`` and ``nu``;
  its variables load for serving equal to the exporter's weights too.
* Vec2Wav: a ``GANTrainState`` in the structure of the JAX package's
  ``init_state`` (built once for the module) with patterned weights and
  AdamW moments, count 7 and learning rate 1.5e-4 resumes into the port's
  ``GANTrainer`` with every module state, moment, count and learning rate
  equal, the weights and moments to the JAX package's exporters
  (``export_vec2wav_generator``, ``_mpd``, ``_msd``) over the state's
  variables, ``mu`` and ``nu``.
* ``export-torch``: the port's files equal the JAX package's ``export-torch``
  (JAX ``cli.main``) on the same directory, key for key and value for
  value, for both stages.
"""

import os
import shutil
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import orbax_full_size
from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu import checkpoint as jckpt
from wavthruvec_pytorch_tpu import cli as jcli
from wavthruvec_pytorch_tpu.config import Text2VecConfig as JT2V
from wavthruvec_pytorch_tpu.config import Vec2WavConfig as JV2W
from wavthruvec_pytorch_tpu.config import load_config as jload_config
from wavthruvec_pytorch_tpu.train import vec2wav_train as jv2w
from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch import cli
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jax_orbax")
T2V_JSON = os.path.join(FIXTURES, "text2vec.json")
V2W_JSON = os.path.join(FIXTURES, "vec2wav.json")
TINY_JSON = os.path.join(REPO, "data", "demo", "text2vec_tiny.json")
GAN_STEP, GAN_LR = 7, 1.5e-4
T2V_STEP, T2V_LR = 3, 2.5e-3


def _patterned(shapes, hyper, count):
    """Values for the leaves ``shapes`` of a training state: patterns
    distinct within every 251 elements, offset by leaf, which a misplaced
    element would break and zstd compresses (second moments and variances
    positive); integers ``count``; the optimizer's ``hyper``."""
    def fill(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in path]
        if "hyperparams" in names:
            return np.asarray(hyper[names[-1]], leaf.dtype)
        if np.issubdtype(leaf.dtype, np.integer):
            return np.asarray(count, leaf.dtype)
        n = int(np.prod(leaf.shape))
        v = ((np.arange(n) * 7 + zlib.crc32("/".join(names).encode())) % 251 - 125) / 125
        if "nu" in names or names[-1] == "var":
            v = np.abs(v) + 0.01
        return v.astype(leaf.dtype).reshape(leaf.shape)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_moments(optimizer, modules, mu, nu, step=None):
    """Every parameter of ``modules`` [(name, module)] that ``optimizer``
    holds has ``exp_avg`` and ``exp_avg_sq`` equal to the JAX exporter's
    ``mu`` and ``nu`` at its torch name (and ``step``, where given), and
    the parameters take every element of the JAX moments.  Returns the
    number of parameters."""
    n = n_elems = 0
    for tag, module in modules:
        for pname, p in module.named_parameters():
            st = optimizer.state[p]
            if not st:
                continue
            assert pname in mu[tag], (tag, pname)
            if step is not None:
                assert float(st["step"]) == step
            assert torch.equal(st["exp_avg"], mu[tag][pname]) and \
                torch.equal(st["exp_avg_sq"], nu[tag][pname]), (tag, pname)
            n, n_elems = n + 1, n_elems + p.numel()
    return n, n_elems


def _leaf_elements(tree) -> int:
    return sum(int(np.size(x)) for x in jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def gan_state(tmp_path_factory):
    """A JAX ``GANTrainState`` at step 7, saved by the JAX package's
    ``save_checkpoint`` as ``state_00000007``.  Its structure, shapes and
    dtypes are ``init_state``'s (``jax.eval_shape``: the init's own
    convolutions take ~80 s on an 8-core Intel Xeon for the full-width discriminators'
    46M parameters); its values ``_patterned``: counts 7, learning rates
    1.5e-4."""
    cfg = jload_config(JV2W, V2W_JSON)
    batch = {"wv_feat": jnp.zeros((1, 8, cfg.n_feat_dim)), "spk_emb": jnp.zeros((1, cfg.spk_dim))}
    shapes = jax.eval_shape(lambda key: jv2w.init_state(cfg, key, batch)[1],
                            jax.random.PRNGKey(4))
    hyper = {"learning_rate": GAN_LR, "b1": cfg.adam_b1, "b2": cfg.adam_b2, "eps": 1e-8,
             "eps_root": 0.0, "weight_decay": 0.01}
    state = _patterned(shapes, hyper, GAN_STEP)
    path = str(tmp_path_factory.mktemp("gan") / f"state_{GAN_STEP:08d}")
    jckpt.save_checkpoint(path, state)
    return path, state


@pytest.fixture(scope="module")
def ecapa_state(tmp_path_factory):
    """A JAX ``T2VTrainState`` at ``data/demo/text2vec_tiny.json``, ECAPA
    on, saved by the JAX package's ``save_checkpoint`` as
    ``checkpoint_3``, with its variables as the JAX ``recalibrate-bn``
    writes them beside it.  Structure from ``init_state``
    (``jax.eval_shape``), values ``_patterned``: step and counts 3,
    learning rate 2.5e-3."""
    cfg = jload_config(JT2V, TINY_JSON)
    assert cfg.use_multi_speaker_condition
    shapes, hyper = orbax_full_size.text2vec_shapes(cfg)
    state = _patterned(shapes, dict(hyper, learning_rate=np.float32(T2V_LR)), T2V_STEP)
    root = tmp_path_factory.mktemp("t2v_ecapa")
    jckpt.save_checkpoint(str(root / f"checkpoint_{T2V_STEP}"), state)
    jckpt.save_checkpoint(str(root / "variables"),
                          {"params": state.params, "batch_stats": state.batch_stats})
    return root, state, cfg


def _equal(a, b, path="obj"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False)


def test_export_torch_equals_jax_t2v(tmp_path):
    args = ["export-torch", "--stage", "t2v", "--checkpoint",
            os.path.join(FIXTURES, "checkpoint_1"), "--config", T2V_JSON]
    assert jcli.main(args + ["--out", str(tmp_path / "jax.pth.tar")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "port.pth.tar")]) == 0
    _equal(_load(tmp_path / "jax.pth.tar"), _load(tmp_path / "port.pth.tar"))


def test_export_torch_equals_jax_v2w(tmp_path, gan_state):
    path, _ = gan_state
    args = ["export-torch", "--stage", "v2w", "--checkpoint", path, "--config", V2W_JSON]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    for name in (f"g_{GAN_STEP:08d}", f"do_{GAN_STEP:08d}"):
        _equal(_load(tmp_path / "jax" / name), _load(tmp_path / "port" / name), name)


def test_gan_state_resumes_with_moments_counts_and_lr(gan_state):
    path, state = gan_state
    jcfg = jload_config(JV2W, V2W_JSON)
    cfg = load_config(Vec2WavConfig, V2W_JSON)
    trainer = GANTrainer(cfg, device="cpu")
    assert ckpt.load_jax_vec2wav(path, trainer) == GAN_STEP + 1
    assert trainer.step_count == GAN_STEP + 1
    state = jax.tree_util.tree_map(np.asarray, state)
    want = {
        "gen": jckpt.export_vec2wav_generator({"params": state.gen_params,
                                               "batch_stats": state.gen_batch_stats,
                                               "spectral": state.gen_spectral}, jcfg),
        "mpd": jckpt.export_vec2wav_mpd({"params": state.disc_params["mpd"]}, jcfg),
        "msd": jckpt.export_vec2wav_msd({"params": state.disc_params["msd"],
                                         "spectral": state.msd_spectral}),
    }
    for name, module in (("gen", trainer.gen), ("mpd", trainer.mpd), ("msd", trainer.msd)):
        got, ref = module.state_dict(), _torch(want[name])
        assert got.keys() == ref.keys(), name
        for k in got:
            assert torch.equal(got[k], ref[k]), (name, k)
    n = n_elems = 0
    for opt, jopt in ((trainer.opt_g, state.opt_g_state), (trainer.opt_d, state.opt_d_state)):
        assert opt.param_groups[0]["lr"] == pytest.approx(GAN_LR, rel=1e-6)
        adam = jopt.inner_state[0]
        if opt is trainer.opt_g:
            parts = [("generator", trainer.gen)]
            mu = {"generator": jckpt.export_vec2wav_generator({"params": adam.mu}, jcfg)}
            nu = {"generator": jckpt.export_vec2wav_generator({"params": adam.nu}, jcfg)}
        else:
            parts = [("mpd", trainer.mpd), ("msd", trainer.msd)]
            mu = {"mpd": jckpt.export_vec2wav_mpd({"params": adam.mu["mpd"]}, jcfg),
                  "msd": jckpt.export_vec2wav_msd({"params": adam.mu["msd"]})}
            nu = {"mpd": jckpt.export_vec2wav_mpd({"params": adam.nu["mpd"]}, jcfg),
                  "msd": jckpt.export_vec2wav_msd({"params": adam.nu["msd"]})}
        k, e = _assert_moments(opt, parts, {t: _torch(m) for t, m in mu.items()},
                               {t: _torch(m) for t, m in nu.items()}, step=GAN_STEP)
        assert e == _leaf_elements(adam.mu)
        n, n_elems = n + k, n_elems + e
    assert n == len(trainer.gen_params) + len(trainer.disc_params)


def test_text2vec_state_with_ecapa_resumes_as_jax_exports_it(ecapa_state):
    root, state, jcfg = ecapa_state
    cfg = load_config(Text2VecConfig, TINY_JSON)
    state = jax.tree_util.tree_map(np.asarray, state)
    lamb = state.opt_state.inner_state
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    want = _torch(jckpt.export_text2vec(variables, jcfg))
    mu = _torch(jckpt.export_text2vec({"params": lamb.mu}, jcfg))
    nu = _torch(jckpt.export_text2vec({"params": lamb.nu}, jcfg))
    assert sum(k.startswith("encoder.speaker_encoder.") for k in mu) > 20

    path = ckpt.text2vec_resume_path(str(root), T2V_STEP)
    assert path == str(root / f"checkpoint_{T2V_STEP}")
    trainer = Text2VecTrainer(cfg, device="cpu")
    assert ckpt.load_text2vec(path, trainer) == 0
    assert trainer.step_count == T2V_STEP
    assert trainer.learning_rate == pytest.approx(T2V_LR, rel=1e-6)
    got = dict(trainer.model.named_parameters())
    stats = {k: v for k, v in trainer.model.named_buffers()
             if k.endswith(("running_mean", "running_var"))}
    for k, v in {**got, **stats}.items():
        assert torch.equal(v.detach(), want[k]), k
    n, n_elems = _assert_moments(trainer.optimizer, [("t2v", trainer.model)],
                                 {"t2v": mu}, {"t2v": nu})
    assert n_elems == _leaf_elements(lamb.mu) and n > 0

    # serving: the variables directory loads to the exporter's weights
    served = ckpt.load_torch_state_dict(str(root / "variables"), "model", cfg)
    for k in {**got, **stats}:
        assert torch.equal(served[k], want[k]), k


def test_text2vec_step_from_jax_state_matches_jax(tmp_path):
    cfg = load_config(Text2VecConfig, T2V_JSON)
    expected = np.load(os.path.join(FIXTURES, "expected.npz"))
    # --restore_step takes the .pth.tar where there is one, else the directory
    shutil.copytree(os.path.join(FIXTURES, "checkpoint_1"), tmp_path / "checkpoint_1")
    assert ckpt.text2vec_resume_path(str(tmp_path), 1) == str(tmp_path / "checkpoint_1")
    trainer = Text2VecTrainer(cfg, device="cpu")
    assert ckpt.load_text2vec(ckpt.text2vec_resume_path(str(tmp_path), 1), trainer) == 0
    assert trainer.step_count == int(expected["step"]) == 1
    assert trainer.learning_rate == pytest.approx(float(expected["lr"]), rel=1e-6)
    # the moments as the JAX package's exporter maps them, read by orbax
    lamb = jckpt.restore_checkpoint(str(tmp_path / "checkpoint_1"), None)["opt_state"]
    lamb = lamb["inner_state"]
    jcfg = jload_config(JT2V, T2V_JSON)
    mu = _torch(jckpt.export_text2vec({"params": lamb["mu"]}, jcfg))
    nu = _torch(jckpt.export_text2vec({"params": lamb["nu"]}, jcfg))
    _, n_elems = _assert_moments(trainer.optimizer, [("t2v", trainer.model)],
                                 {"t2v": mu}, {"t2v": nu})
    assert n_elems == _leaf_elements(lamb["mu"])
    (tmp_path / "checkpoint_1.pth.tar").write_bytes(b"")
    assert ckpt.text2vec_resume_path(str(tmp_path), 1).endswith(".pth.tar")

    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.step({k[len("step_"):]: expected[k] for k in expected.files if k.startswith("step_")})
    assert trainer.step_count == 2
    buffers = dict(trainer.model.named_buffers())
    n_off = n_all = n_stats = 0
    for key in expected.files:
        if not key.startswith("next/"):
            continue
        name, want = key[len("next/"):], expected[key]
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(), want, atol=1e-5, err_msg=name)
            n_stats += 1
        elif name in start and trainer.model.get_parameter(name).requires_grad:
            got = trainer.model.get_parameter(name).detach().numpy()
            diff = np.abs(got - want)
            step = np.abs(want - start[name].numpy())
            off = diff > 1e-5
            assert (diff[off] <= 2 * step.max() + 1e-5).all(), name
            n_off, n_all = n_off + int(off.sum()), n_all + diff.size
    assert n_stats > 0 and n_all > 10_000
    assert n_off <= 1e-3 * n_all
    print(f"resumed step: {n_off} of {n_all} parameter elements beyond 1e-5 of JAX's; "
          f"{n_stats} running statistics within 1e-5")


def test_newest_vec2wav_checkpoint(tmp_path):
    """``train-vec2wav`` resumes from the newest by step, a pair or a JAX
    state; a tie goes to the pair."""
    assert ckpt.newest_vec2wav(str(tmp_path)) is None
    state = tmp_path / f"state_{GAN_STEP:08d}"
    shutil.copytree(os.path.join(FIXTURES, "gen_variables"), state)
    assert ckpt.newest_vec2wav(str(tmp_path)) == ("jax", str(state))
    for step in (3, GAN_STEP):
        for prefix in ("g_", "do_"):
            (tmp_path / f"{prefix}{step:08d}").write_bytes(b"")
        kind, _ = ckpt.newest_vec2wav(str(tmp_path))
        assert kind == ("jax" if step < GAN_STEP else "pair")
