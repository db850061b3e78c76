"""The port's wav2vec 2.0 (``models/wav2vec2.py``) and featurizer
(``data/ingest.py``) against the JAX package's ``Wav2VecFeaturizer``
(transformers' ``FlaxWav2Vec2Model``) on the CPU, at the tiny config of
``tests/test_ingest_featurizer.py``: Flax's seeded weights carried by
``weights.wav2vec2_state_dict``, the same waveforms of mixed lengths (so
the masking and the per-item trims are held too).  Tolerance: atol 2e-4
(f32 on both sides, sums in another order, through LayerNorms)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_ingest_featurizer import TINY_W2V
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.data.ingest import Wav2VecFeaturizer
from wavthruvec_pytorch_tpu_torch.models import wav2vec2 as w2v

BUCKETS = (8000, 16000)
CFG = w2v.Wav2Vec2Config.from_dict(TINY_W2V)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_featurizer(**changes):
    from wavthruvec_pytorch_tpu.data.ingest import Wav2VecFeaturizer as JFeaturizer

    return JFeaturizer(random_init=True, config_overrides={**TINY_W2V, **changes},
                       wav_buckets=BUCKETS)


@pytest.fixture(scope="module")
def pair():
    jf = _jax_featurizer()
    tf = Wav2VecFeaturizer(random_init=True, config_overrides=TINY_W2V, wav_buckets=BUCKETS,
                           device="cpu")
    tf.model.load_state_dict(weights.wav2vec2_state_dict(_np(jf.model.params), CFG), strict=True)
    return jf, tf


def _wavs(lengths, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("lengths", [(6500, 4000, 8000), (12000, 3100), (16000,)],
                         ids=["mixed", "two_buckets_up", "full"])
def test_featurizer_matches_jax(pair, lengths):
    """``extract_batch`` == JAX's on a padded batch: each item's frame count
    exact, the features atol 2e-4."""
    jf, tf = pair
    wavs = _wavs(lengths, sum(lengths))
    want, got = jf.extract_batch(wavs), tf.extract_batch(wavs)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, atol=2e-4, err_msg=f"item {i}")


def test_masking_matches_alone(pair):
    """An item padded in a batch gets what it gets alone at the same bucket
    (the padded frames are zeroed before the positional convolution and
    masked out of attention): atol 1e-5."""
    _, tf = pair
    wavs = _wavs((7000, 2500), 5)
    batched = tf.extract_batch(wavs)
    alone = tf.extract_batch([wavs[1], np.zeros(8000, np.float32)])[0]
    np.testing.assert_allclose(batched[1], alone, atol=1e-5)


def test_conv_bias_and_tanh_gelu():
    """A config with convolution biases and another activation carries too:
    atol 2e-4."""
    changes = dict(conv_bias=True, hidden_act="gelu_new")
    jf = _jax_featurizer(**changes)
    cfg = dataclasses.replace(CFG, **changes)
    tf = Wav2VecFeaturizer(random_init=True, config_overrides=cfg.to_dict(), wav_buckets=BUCKETS,
                           device="cpu")
    tf.model.load_state_dict(weights.wav2vec2_state_dict(_np(jf.model.params), cfg), strict=True)
    wavs = _wavs((5000, 7900), 7)
    for g, w in zip(tf.extract_batch(wavs), jf.extract_batch(wavs)):
        np.testing.assert_allclose(g, w, atol=2e-4)


@pytest.mark.parametrize("spelling", ["weight_norm", "parametrizations", "safetensors"])
def test_load_local_directory(tmp_path, spelling, capsys):
    """A local HF directory loads with ``strict=True``: ``pytorch_model.bin``
    with either weight-norm spelling, a ``wav2vec2.`` prefix and pretraining
    heads (dropped and named), or ``model.safetensors`` parsed by hand."""
    model = w2v.random_model(CFG, seed=3, device="cpu")
    w2v.save_pretrained(model, str(tmp_path))
    sd = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    if spelling == "parametrizations":
        p = "encoder.pos_conv_embed.conv."
        sd = {k.replace(p + "weight_g", p + "parametrizations.weight.original0")
               .replace(p + "weight_v", p + "parametrizations.weight.original1"): v
              for k, v in sd.items()}
        sd = {"wav2vec2." + k: v for k, v in sd.items()}
        sd["quantizer.codevectors"] = torch.zeros(1, 4, 8)
        sd["project_q.weight"] = torch.zeros(8, 8)
        torch.save(sd, tmp_path / "pytorch_model.bin")
    elif spelling == "safetensors":
        os.remove(tmp_path / "pytorch_model.bin")
        _write_safetensors(sd, tmp_path / "model.safetensors")
    loaded = w2v.load_pretrained(str(tmp_path), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    if spelling == "parametrizations":
        out = capsys.readouterr().out
        assert "quantizer.codevectors" in out and "project_q.weight" in out


def _write_safetensors(sd, path):
    import json
    import struct

    header, blobs, off = {}, [], 0
    for k, v in sd.items():
        b = v.contiguous().numpy().tobytes()
        header[k] = {"dtype": "F32", "shape": list(v.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


@pytest.mark.parametrize("changes,match", [(dict(feat_extract_norm="group"), "feat_extract_norm"),
                                           (dict(do_stable_layer_norm=False), "stable_layer")])
def test_refuses_what_flax_refuses(changes, match):
    """Group norm in the feature encoder and post-LN layers raise, as
    transformers' Flax model raises for them."""
    with pytest.raises(NotImplementedError, match=match):
        w2v.Wav2Vec2Model(dataclasses.replace(CFG, **changes), device="cpu")
    with pytest.raises(NotImplementedError):
        _jax_featurizer(**changes).extract_batch(_wavs((4000,), 0))


def test_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Wav2VecFeaturizer(random_init=True, config_overrides=TINY_W2V)
