"""Write ``tests/fixtures/jax_orbax/``: orbax checkpoints of the JAX package
and its answers on them, which the port's orbax reader is held to without
JAX (``tests/test_torch_orbax_*.py``, ``chip_smoke.py`` phase 49).

    JAX_PLATFORMS=cpu python tests/make_jax_orbax_fixtures.py

It imports JAX and runs on the CPU; pytest does not collect it.  It writes:

* ``text2vec.json`` and ``vec2wav.json``: the configs, the demo's tiny ones
  with narrower widths (``n_feat_dim`` 8, the least the card's BiGRU
  kernels take; FFT blocks of width 16 with one head of 16 and filters of
  8; Generator noise and speaker widths 4) and without the ECAPA speaker
  encoder, whose fixed 1536/4608 widths alone hold 1.6M parameters (the
  port's LAMB moments of an ECAPA state are held to JAX's exporter in
  ``tests/test_torch_orbax_resume.py`` on a state made in the test);
  ``flash_attention`` on, dropout 0, one text bucket of 16 and one frame
  bucket of 256 (so the decoder's attention takes the flash kernels on the
  card), ``grad_clip_every`` 2;
* ``checkpoint_1/``: a ``T2VTrainState`` after one JAX step (LAMB moments
  not zero), its learning rate set to ``LR`` in the optimizer state;
* ``t2v_variables/`` ({params, batch_stats} of that state) and
  ``gen_variables/`` ({params, batch_stats, spectral} of a seeded
  Generator), as the JAX ``recalibrate-bn`` writes variables;
* ``expected.npz``: the second step's batch of one item (``step_*``) and
  the parameters after it (``next/<torch key>``, in the torch reference's
  layout), and one request served from the variables (``text``, ``spk``,
  ``noise``, ``total_frames``, and ``latents`` and ``wav`` over those
  frames) with the JAX ``Synthesizer`` and ``Generator(fused=False)``.
"""

import dataclasses
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wavthruvec_pytorch_tpu import checkpoint as ckpt  # noqa: E402
from wavthruvec_pytorch_tpu.config import Text2VecConfig, Vec2WavConfig, load_config  # noqa: E402
from wavthruvec_pytorch_tpu.data.prior import beta_binomial_prior_distribution  # noqa: E402
from wavthruvec_pytorch_tpu.infer.synthesize import Synthesizer  # noqa: E402
from wavthruvec_pytorch_tpu.models import Generator  # noqa: E402
from wavthruvec_pytorch_tpu.text import TextFrontend  # noqa: E402
from wavthruvec_pytorch_tpu.train import text2vec_train as t2v  # noqa: E402

OUT = os.path.join(REPO, "tests", "fixtures", "jax_orbax")
STEP = 1                  # checkpoint_{STEP}
LR = 0.005                # the state's learning rate (not the config's 0.01)
DP_BIAS = 3.0             # raised duration-predictor bias: several frames a token
TEXT = "丸乯京"           # three symbols of data/demo/vocab.txt
MAX_FRAMES = 256
NOISE_SEED = 5
MARGIN = 1e-4             # durations' distance from a rounding edge


def configs():
    demo = os.path.join(REPO, "data", "demo")
    t2v_cfg = dataclasses.replace(
        load_config(Text2VecConfig, os.path.join(demo, "text2vec_tiny.json")),
        n_feat_dim=8, spk_channel=8, n_speaker_dim=8, max_seq_len=MAX_FRAMES,
        encoder_dim=16, encoder_head=1, decoder_dim=16, decoder_head=1,
        encoder_conv1d_filter_size=8, decoder_conv1d_filter_size=8,
        duration_predictor_filter_size=8, use_multi_speaker_condition=False,
        use_speaker_emb_for_alignment=False, dropout=0.0, flash_attention=True,
        text_buckets=(16,), frame_buckets=(MAX_FRAMES,), grad_clip_every=2,
        vocab_path="./data/demo/vocab.txt")
    v2w_cfg = dataclasses.replace(
        load_config(Vec2WavConfig, os.path.join(demo, "vec2wav_tiny.json")),
        n_feat_dim=8, num_wv_feat=8, spk_dim=4, noise_dim=4,
        feat_ground_truth="./data/demo/w2v_feat_tiny")
    return t2v_cfg, v2w_cfg


def batch(cfg, seed: int, lengths):
    rng = np.random.default_rng(seed)
    items = []
    for n, t in lengths:
        items.append({
            "text_enc": rng.integers(1, cfg.vocab_size, n).astype(np.int32),
            "feat_gt_target": (rng.standard_normal((t, cfg.n_feat_dim)) * 0.5).astype(np.float32),
            "attn_prior": beta_binomial_prior_distribution(n, t).astype(np.float32)})
    b = t2v.make_padded_batch(items, cfg)
    b.pop("audiopaths")
    return b


def main() -> int:
    from wavthruvec_pytorch_tpu.config import save_config

    t2v_cfg, v2w_cfg = configs()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    save_config(t2v_cfg, os.path.join(OUT, "text2vec.json"))
    save_config(v2w_cfg, os.path.join(OUT, "vec2wav.json"))

    first = batch(t2v_cfg, 1, [(12, 230), (9, 180)])
    second = batch(t2v_cfg, 2, [(14, 256)])
    model, state = t2v.init_state(t2v_cfg, jax.random.PRNGKey(0),
                                  {k: jnp.asarray(v) for k, v in first.items()})
    params = jax.tree_util.tree_map(np.array, state.params)
    params["duration_predictor"]["linear_layer"]["Dense_0"]["bias"] += np.float32(DP_BIAS)
    state = state._replace(params=params)
    step_fn, _ = t2v.make_train_step(model, t2v_cfg, with_viz=False)
    rng = jax.random.PRNGKey(1)
    state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in first.items()}, rng)
    state = t2v.set_learning_rate(state, LR)
    state = jax.device_get(state)
    ckpt.save_checkpoint(os.path.join(OUT, f"checkpoint_{STEP}"), state)
    ckpt.save_checkpoint(os.path.join(OUT, "t2v_variables"),
                         {"params": state.params, "batch_stats": state.batch_stats})

    nxt, _ = step_fn(jax.tree_util.tree_map(jnp.asarray, state),
                     {k: jnp.asarray(v) for k, v in second.items()}, rng)
    nxt = jax.device_get(nxt)
    assert int(nxt.step) == STEP + 1
    next_sd = ckpt.export_text2vec({"params": nxt.params, "batch_stats": nxt.batch_stats},
                                   t2v_cfg)
    # the parameters JAX trains (no constant tables, no dead weight)
    trained = ckpt.export_text2vec({"params": nxt.params, "batch_stats": {}}, t2v_cfg).keys() - \
        {"encoder.position_enc.weight", "decoder.position_enc.weight",
         "postnet.pre_highway.weight"}

    gen = Generator(v2w_cfg)
    gen_vars = jax.device_get(gen.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 8, v2w_cfg.n_feat_dim)),
        jnp.zeros((1, v2w_cfg.spk_dim)), jnp.zeros((1, v2w_cfg.noise_dim)), train=False))
    ckpt.save_checkpoint(os.path.join(OUT, "gen_variables"), gen_vars)

    t2v_vars = ckpt.restore_checkpoint(os.path.join(OUT, "t2v_variables"), None)
    gen_vars = ckpt.restore_checkpoint(os.path.join(OUT, "gen_variables"), None)
    frontend = TextFrontend.from_vocab_file(os.path.join(REPO, "data", "demo", "vocab.txt"))
    syn = Synthesizer(t2v_cfg, v2w_cfg, t2v_vars, gen_vars, frontend,
                      gen=Generator(v2w_cfg, fused=False))
    ref = np.zeros((1, 16, t2v_cfg.n_feat_dim), np.float32)
    rng_np = np.random.default_rng(3)
    spk = rng_np.standard_normal((1, v2w_cfg.spk_dim)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(NOISE_SEED),
                                         (1, v2w_cfg.noise_dim)), np.float32)
    lat = syn.text_to_latents([TEXT], ref, max_frames=MAX_FRAMES)
    dp = np.asarray(model.apply(t2v_vars, *_infer_inputs(frontend, t2v_cfg),
                                method=model.infer)["duration_predictor_output"])
    ids = np.asarray(frontend.encode_batch([TEXT], pad_to=16)[0])
    dist = np.abs((dp + 0.5) - np.round(dp + 0.5))[ids != 0]
    assert dist.min() >= MARGIN, f"a duration {dist.min():.2g} from a rounding edge"
    assert 0 < int(lat["total_frames"][0]) <= MAX_FRAMES, lat["total_frames"]
    wav = syn.latents_to_wav(lat["feat_postnet_output"], spk, noise=noise)

    np.savez_compressed(
        os.path.join(OUT, "expected.npz"),
        **{f"step_{k}": v for k, v in second.items()},
        **{f"next/{k}": np.asarray(v) for k, v in next_sd.items()
           if k in trained or k.endswith(("running_mean", "running_var"))},
        text=np.array(TEXT), spk=spk, noise=noise, ref=ref,
        latents=np.asarray(lat["feat_postnet_output"])[:, :int(lat["total_frames"][0])],
        total_frames=np.asarray(lat["total_frames"]),
        wav=np.asarray(wav)[:, :int(lat["total_frames"][0]) * v2w_cfg.total_upsample],
        lr=np.float32(LR), step=np.int64(STEP))
    total = 0
    for root, _, files in os.walk(OUT):
        total += sum(os.path.getsize(os.path.join(root, f)) for f in files)
    print(json.dumps({"out": OUT, "bytes": total,
                      "total_frames": int(lat["total_frames"][0]),
                      "params": int(sum(np.size(x) for x in
                                        jax.tree_util.tree_leaves(state.params)))}))
    return 0


def _infer_inputs(frontend, cfg):
    ids = np.asarray(frontend.encode_batch([TEXT], pad_to=16)[0])
    pos = np.where(ids != 0, np.arange(1, 17)[None], 0)
    ref = jnp.zeros((1, 16, cfg.n_feat_dim), jnp.float32)
    return jnp.asarray(ids), jnp.asarray(pos), ref, MAX_FRAMES, 1.0


if __name__ == "__main__":
    sys.exit(main())
