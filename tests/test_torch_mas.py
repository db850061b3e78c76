"""The port's width-1 MAS (``ops/mas.py``) against the JAX package on the CPU.

A CPU tensor takes ``mas_width1_plain``, the CUDA kernel's yardstick; the
kernel itself is held equal to it on the card by ``chip_smoke.py``.  The
hard map is compared exactly (0/1 values, tolerance 0) with the ``lax.scan``
version the JAX model calls (``mas_width1_batched``), the Pallas kernel in
interpret mode (``mas_width1_pallas``) and, where a path of nonzero cells
exists, the reference's numpy transcription (``mas_width1_numpy``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavthruvec_pytorch_tpu.ops.mas import mas_width1_batched, mas_width1_numpy
from wavthruvec_pytorch_tpu.ops.mas_pallas import mas_width1_pallas
from wavthruvec_pytorch_tpu_torch.ops.mas import mas_width1, mas_width1_plain


def _case(name):
    """(attn [B, T, N] f32, in_lens, out_lens) from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "full":  # every frame and text position valid
        B, T, N = 2, 24, 7
        in_lens, out_lens = np.full(B, N), np.full(B, T)
    else:  # variable lengths, out_len < T, in_len <= out_len
        B, T, N = 4, 40, 12
        in_lens, out_lens = np.array([12, 9, 5, 1]), np.array([40, 23, 11, 6])
    logits = rng.standard_normal((B, T, N)).astype(np.float32)
    if name == "sharp":
        # ConvAttention-like: a softmax over text at temperature 0.0005 of
        # distances in the hundreds underflows to exact zeros in f32, so
        # whole regions, and the best path, pass through log(0)
        logits = logits * np.float32(200.0)
    attn = np.exp(logits - logits.max(-1, keepdims=True))
    attn = (attn / attn.sum(-1, keepdims=True)).astype(np.float32)
    if name == "zeros":
        # exact zeros off the diagonal band, so a path of nonzero cells exists
        i, j = np.meshgrid(np.arange(T), np.arange(N), indexing="ij")
        band = np.abs(j - i * (N - 1) / (T - 1)) <= 1.5
        attn[:, ~band & (rng.random((T, N)) < 0.5)] = 0.0
    return attn, in_lens.astype(np.int32), out_lens.astype(np.int32)


def _numpy_oracle(attn, in_lens, out_lens):
    want = np.zeros(attn.shape, np.float32)
    for b, (n, t) in enumerate(zip(in_lens, out_lens)):
        want[b, :t, :n] = mas_width1_numpy(attn[b, :t, :n])
    return want


def _port(attn, in_lens, out_lens):
    return mas_width1(torch.tensor(attn), torch.tensor(in_lens), torch.tensor(out_lens)).numpy()


@pytest.mark.parametrize("name", ["full", "lengths", "zeros", "sharp"])
def test_mas_plain_equals_jax(name):
    """Equal, tolerance 0, to the lax.scan and Pallas versions."""
    attn, in_lens, out_lens = _case(name)
    if name == "sharp":
        assert (attn == 0).mean() > 0.5
    got = _port(attn, in_lens, out_lens)
    args = (jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens))
    np.testing.assert_array_equal(got, np.asarray(mas_width1_batched(*args)))
    np.testing.assert_array_equal(got, np.asarray(mas_width1_pallas(*args, interpret=True)))
    for b, (n, t) in enumerate(zip(in_lens, out_lens)):
        assert got[b, t:].sum() == 0 and got[b, :, n:].sum() == 0
        if name != "sharp":  # one text position per valid frame
            np.testing.assert_array_equal(got[b, :t].sum(-1), np.ones(t))
    if name == "sharp":
        # where the path reaches text column 0 through a zero cell, its
        # score is exactly -1e30, the left neighbour's -1e30 ties with it,
        # the tie goes left, and the backtrack leaves the map: the frames
        # above get no text position (the reference's -inf never does this)
        assert (got.sum(-1)[np.arange(attn.shape[1])[None] < out_lens[:, None]] == 0).any()


@pytest.mark.parametrize("name", ["full", "lengths", "zeros"])
def test_mas_plain_equals_numpy_oracle(name):
    """Equal, tolerance 0, to the reference's numba semantics.  Not for
    "sharp": where every path crosses a zero, the oracle's -inf makes all
    paths tie while -1e30 (JAX and the port) still ranks them."""
    attn, in_lens, out_lens = _case(name)
    np.testing.assert_array_equal(_port(attn, in_lens, out_lens),
                                  _numpy_oracle(attn, in_lens, out_lens))


def test_mas_wrapper_routes_by_device():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on a device that is neither CPU nor CUDA raises."""
    attn, in_lens, out_lens = _case("lengths")
    before = mas_width1.launches
    np.testing.assert_array_equal(
        _port(attn, in_lens, out_lens),
        mas_width1_plain(torch.tensor(attn), torch.tensor(in_lens), torch.tensor(out_lens)).numpy())
    assert mas_width1.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        mas_width1(torch.empty(1, 4, 3, device="meta"), torch.ones(1, dtype=torch.int32),
                   torch.ones(1, dtype=torch.int32))
