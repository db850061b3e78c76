"""The port's data parallelism (``parallel/mesh.py``) on two ranks over gloo
on the CPU, against the JAX package's two-device mesh on the global batch.

The ranks run in spawned processes that import no JAX
(``tests/_torch_parallel_worker.py``, started by ``parallel.launch.run_local``,
each wait with its own deadline); one pair of ranks runs every case of the
file, on a thread of this process while JAX's side compiles.  JAX's side
runs here, on the virtual CPU devices of ``tests/conftest.py``; its mesh
step is compiled once for the file.  The configs are ``test_torch_train.py``'s Text2Vec step config
(dropout 0, one text bucket of 16 and one frame bucket of 64, the clip on
every step) and ``test_torch_gan_step.py``'s GAN config.

Tolerances: those of the one-process parity tests, since the only
difference is the order of f32 sums (``ROADMAP.md``, Tolerance).  Losses
rtol 1e-5; BatchNorm outputs, gradients and statistics atol 1e-5; the
parameters after LAMB or AdamW by the sign-like first step's rule of
``test_torch_train.py`` and ``test_torch_gan_step.py``.  The ranks'
parameters after a step are bit-equal to each other.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests import _torch_parallel_worker as worker
from tests._torch_parallel_worker import torch_one_thread  # noqa: F401 (a fixture)
from tests.test_torch_device_cache import t2v_corpus  # noqa: F401 (a fixture)
from tests.test_torch_gan_step import CFG as GAN_CFG
from tests.test_torch_train import CFG, JCFG, _init_params, _items, _rand, _randomize_stats
from wavthruvec_pytorch_tpu.data.dataset import BucketedLoader as JBucketedLoader
from wavthruvec_pytorch_tpu.data.device_cache import DeviceResidentData as JDeviceResidentData
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu.models.text2vec import Text2Vec as JText2Vec
from wavthruvec_pytorch_tpu.parallel import mesh as jmesh
from wavthruvec_pytorch_tpu.train import text2vec_train as jtrain
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader
from wavthruvec_pytorch_tpu_torch.data.device_cache import DeviceResidentData
from wavthruvec_pytorch_tpu_torch.parallel import mesh
from wavthruvec_pytorch_tpu_torch.parallel.launch import run_local
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import (
    BATCH_KEYS,
    batch_to_device,
    make_padded_batch,
)
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer, log_mel

# two global batches of 8, one padded shape: four items a rank
BALANCED = [(12, 64), (9, 60), (5, 57), (7, 50), (16, 64), (10, 62), (8, 40), (11, 58)]
# rank 0 long texts and frames, rank 1 short ones: the ranks' binarization
# ratios differ, and so does their mean from the global ratio
UNEQUAL = [(16, 64), (15, 62), (16, 60), (14, 64), (3, 8), (2, 6), (3, 10), (4, 9)]
CASES = {"balanced": BALANCED, "unequal": UNEQUAL}
TIMEOUT = 240.0


def _global_batch(lengths, seed):
    return make_padded_batch(_items(CFG, lengths, seed=seed), CFG, text_pad=16, frame_pad=64)


GAN_B, GAN_T = 4, 4


def _gan_batch():
    rng = np.random.default_rng(12)
    audio = (rng.standard_normal((GAN_B, GAN_T * GAN_CFG.total_upsample, 1)) * 0.1
             ).astype(np.float32)
    return {"wv_feat": rng.standard_normal((GAN_B, GAN_T, GAN_CFG.n_feat_dim)).astype(np.float32),
            "spk_emb": rng.standard_normal((GAN_B, GAN_CFG.spk_dim)).astype(np.float32),
            "audio": audio, "mel_loss": log_mel(GAN_CFG, torch.from_numpy(audio)).numpy()}


# --- the layer's helpers -------------------------------------------------------

@pytest.mark.parametrize("n_items,count", [(10, 2), (11, 2), (7, 3), (5, 1)])
def test_process_shard_matches_jax(n_items, count):
    """Each rank's share of a file list == JAX's ``process_shard`` with the
    same explicit rank and count; the shares are disjoint and equal in
    length."""
    items = [f"line{i}" for i in range(n_items)]
    shares = [mesh.process_shard(items, i, count) for i in range(count)]
    for i, share in enumerate(shares):
        assert share == jmesh.process_shard(items, i, count)
    assert len({len(s) for s in shares}) == 1
    assert len(set().union(*shares)) == sum(len(s) for s in shares)


@pytest.mark.parametrize("global_batch,n_ranks", [(16, 1), (16, 2), (5, 2), (12, 8)])
def test_local_batch_size_matches_jax(monkeypatch, global_batch, n_ranks):
    """``local_batch_size`` == JAX's at the same count of ranks (processes
    there): the quotient, or a ValueError when the batch does not divide."""
    monkeypatch.setattr(mesh, "world_size", lambda: n_ranks)
    monkeypatch.setattr(jax, "process_count", lambda: n_ranks)
    if global_batch % n_ranks:
        with pytest.raises(ValueError):
            jmesh.local_batch_size(global_batch)
        with pytest.raises(ValueError, match="not divisible"):
            mesh.local_batch_size(global_batch)
    else:
        assert mesh.local_batch_size(global_batch) == jmesh.local_batch_size(global_batch)


def test_single_process_is_a_no_op():
    """Without a process group: no world, rank 0 of 1, the whole file list,
    and the collectives leave tensors bit for bit as they were."""
    assert not mesh.group_active() and mesh.mesh_for_batch(16) is None
    assert (mesh.rank(), mesh.world_size(), mesh.is_main_process()) == (0, 1, True)
    assert mesh.process_shard(list("abc")) == list("abc")
    t = torch.randn(5)
    before = t.clone()
    mesh.all_reduce_mean([t])
    assert mesh.all_reduce_sum(t) is t
    mesh.globalize_state([torch.nn.Linear(2, 2)])
    assert torch.equal(t, before)
    scalars = {"a": t[0], "b": t[1].to(torch.bfloat16)}
    means = mesh.mean_scalars(scalars)
    assert all(torch.equal(means[k], v) and means[k].dtype == v.dtype
               for k, v in scalars.items())
    local = mesh.shard_batch({"x": np.arange(6.0), "names": list("abcdef")}, None)
    assert local["x"].shape == (6,) and local["names"] == list("abcdef")


def test_pad_to_max_batches_and_bucket_shapes_match_jax(t2v_corpus):
    """A rank's loader (its local batch of 1 of the global 2, ``pad_to_max``):
    every batch padded to the largest bucket pair, equal to JAX's
    ``BucketedLoader(batch_size=, pad_to_max=True)`` and to the device
    cache's ``batch(idx, pad_to_max=True)``, exactly; ``bucket_shapes`` ==
    JAX's.  ``pad_to_max`` defaults to off at world size 1."""
    cfg, jcfg, buffer, jbuffer = t2v_corpus
    assert not BucketedLoader(buffer, cfg).pad_to_max
    loader = BucketedLoader(buffer, cfg, seed=3, batch_size=1, pad_to_max=True)
    jloader = JBucketedLoader(jbuffer, jcfg, seed=3, batch_size=1, pad_to_max=True)
    idx_loader = BucketedLoader(buffer, cfg, seed=3, batch_size=1, pad_to_max=True)
    cache = DeviceResidentData(buffer, cfg, device="cpu")
    jcache = JDeviceResidentData(jbuffer, jcfg)
    assert loader.bucket_shapes() == jloader.bucket_shapes() and len(loader.bucket_shapes()) > 1
    n = 0
    for (hb, jb, idx) in zip((loader.batch(i) for i in loader.epoch_indices()), jloader.epoch(),
                             idx_loader.epoch_indices()):
        got = cache.batch(idx, pad_to_max=True)
        jgot = jcache.batch(idx, pad_to_max=True)
        assert hb["attn_prior"].shape[1:] == (cfg.frame_buckets[-1], cfg.text_buckets[-1])
        want = batch_to_device(hb, torch.device("cpu"))
        for k in BATCH_KEYS:
            np.testing.assert_array_equal(hb[k], jb[k], err_msg=k)
            assert torch.equal(got[k], want[k]), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]), err_msg=k)
        n += 1
    assert n == len(loader) == 8


# --- BatchNorm and the Text2Vec step: one pair of ranks -------------------------

def _bn_inputs():
    rng = np.random.default_rng(11)
    x = _rand(rng, (8, 9, 6), 2.0) + 0.5
    cot = _rand(rng, (8, 9, 6))
    params = {"scale": _rand(rng, 6), "bias": _rand(rng, 6)}
    stats = {"mean": _rand(rng, 6, 0.1), "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    return x, cot, params, stats


@pytest.fixture(scope="module")
def start():
    """Seeded weights and BatchNorm statistics of ``JCFG``'s Text2Vec, as
    JAX trees and as the port's state dict."""
    jb = {k: jnp.asarray(v) for k, v in _global_batch(BALANCED, 7).items()}
    args = tuple(jb[k] for k in ("text", "src_pos", "feat_target", "input_lengths",
                                 "output_lengths", "feat_pos"))
    shapes = jax.eval_shape(lambda key: JText2Vec(JCFG).init(
        {"params": key, "dropout": key}, *args, attn_prior=jb["attn_prior"],
        deterministic=True, train_bn=False), jax.random.PRNGKey(0))
    params = _init_params(shapes["params"], 8)
    stats = _randomize_stats(shapes["batch_stats"], 8)
    sd = weights.text2vec_state_dict({"params": params, "batch_stats": stats}, JCFG)
    return params, stats, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(start):
    """Both ranks' BatchNorm results, their Text2Vec steps on each case and
    their GAN step, run on a thread: ``.result()`` waits for them."""
    x, cot, params, stats = _bn_inputs()
    bn_state = {"weight": params["scale"], "bias": params["bias"],
                "running_mean": stats["mean"], "running_var": stats["var"],
                "num_batches_tracked": np.zeros((), np.int64)}
    batches = [_global_batch(lengths, 7 + i) for i, lengths in enumerate(CASES.values())]
    cfg_fields = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    gan_fields = {f.name: getattr(GAN_CFG, f.name) for f in dataclasses.fields(GAN_CFG)}
    args = ((x, cot, bn_state), (cfg_fields, start[2], batches), (gan_fields, _gan_batch()))
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_local, worker.all_steps, 2, args, TIMEOUT)

        class Results:
            @functools.cached_property
            def value(self):
                out = future.result(timeout=TIMEOUT + 60)
                return {"bn": [o[0] for o in out],
                        "t2v": {name: [o[1][i] for o in out] for i, name in enumerate(CASES)},
                        "gan": [o[2] for o in out]}

        yield Results()


@pytest.fixture(scope="module")
def jax_steps(start):
    """JAX's ``make_train_step(mesh=create_mesh(2))`` on each global batch
    from the same start: metrics and the new state in the port's keys."""
    params, stats, _ = start
    model = JText2Vec(JCFG)
    tx = jtrain.make_optimizer(JCFG)
    mesh2 = jmesh.create_mesh(2)
    step, _ = jtrain.make_train_step(model, JCFG, mesh=mesh2, with_viz=False)
    out = {}
    for i, (name, lengths) in enumerate(CASES.items()):
        jb = {k: jnp.asarray(v) for k, v in _global_batch(lengths, 7 + i).items()}
        state = jtrain.T2VTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=stats, opt_state=tx.init(params))
        new, metrics = step(state, jmesh.shard_batch(jb, mesh2), jax.random.PRNGKey(1))
        new = jax.tree_util.tree_map(np.asarray, new)
        out[name] = {"losses": [float(metrics[k]) for k in jtrain.SCALAR_KEYS],
                     "new": weights.text2vec_state_dict(
                         {"params": new.params, "batch_stats": new.batch_stats}, JCFG)}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_text2vec_step_matches_jax_mesh(ranks, jax_steps, start, case):
    """One step on two ranks == JAX's step over a two-device mesh on the
    global batch: the five losses rtol 1e-5 on each rank; the BatchNorm
    running statistics atol 1e-5; the parameters after the clip and LAMB
    within atol 1e-5 in at least 99.9% of all elements, the rest within
    twice the tensor's largest step (``test_torch_train.py``'s rule, the
    tensors whose gradient is 0 but for rounding left out); the ranks'
    states bit-equal."""
    r0, r1 = ranks.value["t2v"][case]
    want = jax_steps[case]
    assert r0["digest"] == r1["digest"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    n_off = n_all = 0
    for name, v in want["new"].items():
        got, ref = r0["state"][name], v.numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
        elif name in r0["grads"] and np.abs(r0["grads"][name]).max() > 1e-5:
            diff = np.abs(got - ref)
            off = diff > 1e-5
            assert (diff[off] <= 2 * np.abs(ref - start[2][name]).max() + 1e-5).all(), name
            n_off, n_all = n_off + int(off.sum()), n_all + diff.size
    assert n_all > 0 and n_off <= 1e-3 * n_all
    print(f"{case}: losses {r0['losses']} JAX {want['losses']}; {n_off} of {n_all} "
          "parameter elements beyond 1e-5 of JAX's")


def test_binarization_normalizer_is_global(ranks, jax_steps):
    """Where the ranks hold very different lengths, the mean of the ranks'
    own binarization ratios misses JAX's global loss by far more than the
    tolerance (rtol 1e-5), and the port's global normalizer meets it."""
    for case in CASES:
        r0, r1 = ranks.value["t2v"][case]
        want = jax_steps[case]["losses"][4]
        naive = (r0["own_binarization"] + r1["own_binarization"]) / 2
        np.testing.assert_allclose(r0["losses"][4], want, rtol=1e-5)
        print(f"{case}: global {r0['losses'][4]:.6g}, mean of the ranks' ratios {naive:.6g}, "
              f"JAX {want:.6g}")
        if case == "unequal":
            assert abs(naive - want) > 1e-2 * abs(want)


def test_global_batch_norm_matches_jax(ranks):
    """Two ranks of four items each == flax ``nn.BatchNorm`` on the eight:
    the output and the input gradient (the ranks' rows concatenated), the
    parameter gradients of the global loss and the running statistics,
    atol 1e-5; the ranks' statistics are bit-equal."""
    x, cot, params, stats = _bn_inputs()
    jm = jl.BatchNorm(use_running_average=False)

    def jloss(p, x):
        y, mut = jm.apply({"params": {"BatchNorm_0": p},
                           "batch_stats": {"BatchNorm_0": stats}}, x, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"]["BatchNorm_0"])

    (_, (y, new_stats)), (dp, dx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    r0, r1 = ranks.value["bn"]
    np.testing.assert_allclose(np.concatenate([r0["y"], r1["y"]]), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r0["dx"], r1["dx"]]), np.asarray(dx), atol=1e-5)
    np.testing.assert_allclose(r0["dweight"], np.asarray(dp["scale"]), atol=1e-5)
    np.testing.assert_allclose(r0["dbias"], np.asarray(dp["bias"]), atol=1e-5)
    for k, jk in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_array_equal(r0[k], r1[k])
        np.testing.assert_allclose(r0[k], np.asarray(new_stats[jk]), atol=1e-5)


# --- the GAN step -------------------------------------------------------------

@pytest.fixture(scope="module")
def gan_pair(ranks):
    """The ranks' GAN step (two items each) and the port's one-process step
    (held against JAX by ``test_torch_gan_step.py``) on the four, both from
    the modules and noise stream of seed 0."""
    torch.manual_seed(0)
    one = GANTrainer(GAN_CFG, device="cpu", seed=0)
    metrics = one.step(_gan_batch())
    return ranks.value["gan"], one, [metrics[k].item() for k in SCALAR_KEYS]


def test_gan_step_matches_one_process(gan_pair):
    """Two ranks == one process on the global batch: the four losses rtol
    1e-5; the gradients (the Generator's whole, every 101st element of the
    discriminators') atol 1e-4 of their tensor's largest plus 1e-5 of their
    module's; the parameters after AdamW atol 1e-6 where the two gradients
    agree in sign and exceed 1e-4, else within 2 lr + 1e-6 (AdamW's first
    step is sign-like); the spectral vectors atol 1e-5.  The ranks' states,
    spectral vectors included, are bit-equal: the power iteration reads only
    weights that every rank holds alike."""
    (r0, r1), one, losses = gan_pair
    assert r0["digest"] == r1["digest"]
    for r in (r0, r1):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    named = {**{n: (p, p.grad.flatten()) for n, p in one.gen.named_parameters()},
             **{f"{m}.{n}": (p, p.grad.flatten()[::worker.D_SAMPLE])
                for m, mod in (("mpd", one.mpd), ("msd", one.msd))
                for n, p in mod.named_parameters()}}
    got_g = {**r0["gen_grads"], **r0["disc_grads"]}
    got_p = {**{n: r0["gen"][n] for n, _ in one.gen.named_parameters()}, **r0["disc"]}
    lr = GAN_CFG.learning_rate
    scale = {m: max(np.abs(g.numpy()).max() for n, (_, g) in named.items()
                    if n.startswith(m) == (m != "gen") or (m == "gen" and "." in n and
                                                            not n.startswith(("mpd", "msd"))))
             for m in ("gen", "mpd", "msd")}
    for name, (p, g) in named.items():
        m = name.split(".")[0] if name.startswith(("mpd.", "msd.")) else "gen"
        ref_g = g.numpy()
        np.testing.assert_allclose(got_g[name].flatten(), ref_g,
                                   atol=1e-4 * np.abs(ref_g).max() + 1e-5 * scale[m],
                                   err_msg=name)
        ref_p = (p.detach().flatten() if m == "gen"
                 else p.detach().flatten()[::worker.D_SAMPLE]).numpy()
        agree = (np.sign(got_g[name].flatten()) == np.sign(ref_g)) & (np.abs(ref_g) > 1e-4)
        diff = np.abs(got_p[name].flatten() - ref_p)
        assert (diff[agree] <= 1e-6).all(), name
        assert (diff <= 2 * lr + 1e-6).all(), name
    spectral = {n: v.numpy() for mod in (one.gen, one.msd) for n, v in mod.state_dict().items()
                if n.endswith(("_u", "_v"))}
    assert spectral and set(spectral) == set(r0["spectral"])
    for n, v in spectral.items():
        np.testing.assert_array_equal(r0["spectral"][n], r1["spectral"][n])
        np.testing.assert_allclose(r0["spectral"][n], v, atol=1e-5, err_msg=n)
