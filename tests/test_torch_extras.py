"""The port's lawlict ECAPA, Prenet and PostNet against the JAX package's on
the CPU: JAX's seeded variables (BatchNorm statistics randomised) carried by
``weights.py`` into the reference's keys, the same inputs, eval mode and
batch statistics.  Tolerance: atol 1e-4 (f32, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import _randomize_stats
from wavthruvec_pytorch_tpu.models.ecapa_lawlict import ECAPA_TDNN_Lawlict as JLawlict
from wavthruvec_pytorch_tpu.models.extras import PostNet as JPostNet
from wavthruvec_pytorch_tpu.models.extras import Prenet as JPrenet
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.models.ecapa_lawlict import ECAPA_TDNN_Lawlict
from wavthruvec_pytorch_tpu_torch.models.extras import PostNet, Prenet
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "batch_stats"])
def test_lawlict_ecapa(train):
    """[B, T, 80] -> [B, 192] at channels 64 (the 1536-channel aggregation
    as in the JAX package), B = 8."""
    x = _x((8, 50, 80), 0)
    jm = JLawlict(in_channels=80, channels=64, embd_dim=192)
    jv = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    jv["batch_stats"] = _randomize_stats(jv["batch_stats"], 1)
    want = jm.apply(jv, jnp.asarray(x), train=train, mutable=["batch_stats"] if train else False)
    want = want[0] if train else want
    tm = ECAPA_TDNN_Lawlict(80, 64, 192, device="cpu")
    tm.load_state_dict(weights.lawlict_state_dict(jv), strict=True)
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    assert got.shape == (8, 192)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_prenet():
    """Prenet in eval mode (dropout off); the reference's key names."""
    x = _x((3, 7, 24), 1)
    jm = JPrenet(hidden_size=48, output_size=16)
    jv = _np(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jm.apply(jv, jnp.asarray(x), deterministic=True))
    tm = Prenet(24, 48, 16, device="cpu").eval()
    sd = weights.prenet_state_dict(jv)
    assert set(sd) == {"layer.fc1.linear_layer.weight", "layer.fc1.linear_layer.bias",
                       "layer.fc2.linear_layer.weight", "layer.fc2.linear_layer.bias"}
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.tensor(x)).numpy(), want, atol=1e-5)
    tm.train()
    assert (tm(torch.tensor(x)) == 0).float().mean() > 0.4  # dropout 0.5 in train mode


@pytest.mark.parametrize("train", [False, True], ids=["eval", "batch_stats"])
def test_postnet(train):
    """PostNet with BatchNorm on running and on batch statistics, dropout off
    on both sides (JAX: ``deterministic=True``; the port in eval mode with
    only its BatchNorms in train mode)."""
    x = _x((4, 13, 20), 2)
    jm = JPostNet(n_mel_channels=20, postnet_embedding_dim=32)
    jv = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    jv["batch_stats"] = _randomize_stats(jv["batch_stats"], 3)
    out = jm.apply(jv, jnp.asarray(x), train=train, deterministic=True,
                   mutable=["batch_stats"] if train else False)
    want = np.asarray(out[0] if train else out)
    tm = PostNet(20, 32, device="cpu").eval()
    tm.load_state_dict(weights.postnet_state_dict(jv), strict=True)
    if train:
        for m in tm.modules():
            if isinstance(m, BatchNorm):
                m.train()
    with torch.no_grad():
        got = tm(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
