"""The port's width-1 MAS (``ops/mas.py``) against the JAX package on the CPU.

A CPU tensor takes ``mas_width1_plain``, the CUDA kernel's yardstick; the
kernel itself is held equal to it on the card by ``chip_smoke.py``.  The
hard map is compared exactly (0/1 values, tolerance 0) with the ``lax.scan``
version the JAX model calls (``mas_width1_batched``), the Pallas kernel in
interpret mode (``mas_width1_pallas``) and, where a path of nonzero cells
exists, the reference's numpy transcription (``mas_width1_numpy``).  The
kernel's plan (``mas_plan``: blocks an item, columns a block, shared
memory) is checked here for every N it takes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavthruvec_pytorch_tpu.ops.mas import mas_width1_batched, mas_width1_numpy
from wavthruvec_pytorch_tpu.ops.mas_pallas import mas_width1_pallas
from wavthruvec_pytorch_tpu_torch.ops.mas import (
    MAX_CLUSTER,
    MAX_K,
    MAX_N,
    mas_plan,
    mas_width1,
    mas_width1_plain,
    shared_bytes,
)

# the edges: (B, T, N, in_lens, out_lens)
EDGES = {
    "out_len0": (3, 20, 12, [12, 7, 12], [0, 20, 13]),
    "in_len0": (3, 20, 12, [0, 12, 5], [15, 20, 9]),
    "in_gt_out": (3, 20, 12, [12, 12, 9], [8, 20, 3]),
    "T1": (2, 1, 5, [5, 3], [1, 1]),
    "N1": (3, 10, 1, [1, 1, 1], [10, 4, 1]),
    "N33": (2, 40, 33, [33, 20], [40, 30]),  # one column past a warp
}
H100_SHARED = 232448  # bytes a block may opt into (227 KB)


def _case(name):
    """(attn [B, T, N] f32, in_lens, out_lens) from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "full":  # every frame and text position valid
        B, T, N = 2, 24, 7
        in_lens, out_lens = np.full(B, N), np.full(B, T)
    elif name in EDGES:
        B, T, N, in_lens, out_lens = EDGES[name]
        in_lens, out_lens = np.array(in_lens), np.array(out_lens)
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
        if t > 0:  # an item without frames stays 0
            want[b, :t, :n] = mas_width1_numpy(attn[b, :t, :n])
    return want


def _port(attn, in_lens, out_lens):
    return mas_width1(torch.tensor(attn), torch.tensor(in_lens), torch.tensor(out_lens)).numpy()


@pytest.mark.parametrize("name", ["full", "lengths", "zeros", "sharp", *EDGES])
def test_mas_plain_equals_jax(name):
    """Equal, tolerance 0, to the lax.scan and Pallas versions (at T = 1 to
    the Pallas version alone: the lax.scan version's scan over the T - 1
    rows past the first raises on none)."""
    attn, in_lens, out_lens = _case(name)
    if name == "sharp":
        assert (attn == 0).mean() > 0.5
    got = _port(attn, in_lens, out_lens)
    args = (jnp.asarray(attn), jnp.asarray(in_lens), jnp.asarray(out_lens))
    if attn.shape[1] > 1:
        np.testing.assert_array_equal(got, np.asarray(mas_width1_batched(*args)))
    np.testing.assert_array_equal(got, np.asarray(mas_width1_pallas(*args, interpret=True)))
    for b, (n, t) in enumerate(zip(in_lens, out_lens)):
        # nothing past the lengths but opt[0, 0], set for every item with frames
        assert got[b, t:].sum() == 0 and got[b, :, max(n, 1):].sum() == 0
        if t == 0:
            assert got[b].sum() == 0
        elif n == 0:
            assert got[b].sum() == 1 and got[b, 0, 0] == 1
        elif name != "sharp":
            # one text position per valid frame; with more text positions
            # than frames the path cannot reach column 0, and row 0 gets it
            # besides its own
            want = np.ones(t)
            want[0] += n > t
            np.testing.assert_array_equal(got[b, :t].sum(-1), want)
    if name == "sharp":
        # where the path reaches text column 0 through a zero cell, its
        # score is exactly -1e30, the left neighbour's -1e30 ties with it,
        # the tie goes left, and the backtrack leaves the map: the frames
        # above get no text position (the reference's -inf never does this)
        assert (got.sum(-1)[np.arange(attn.shape[1])[None] < out_lens[:, None]] == 0).any()


@pytest.mark.parametrize("name", ["full", "lengths", "zeros", "out_len0", "in_gt_out", "T1",
                                  "N1", "N33"])
def test_mas_plain_equals_numpy_oracle(name):
    """Equal, tolerance 0, to the reference's numba semantics.  Not for
    "sharp": where every path crosses a zero, the oracle's -inf makes all
    paths tie while -1e30 (JAX and the port) still ranks them; not for
    "in_len0", where the oracle has no text to align and the JAX package
    and the port still set opt[0, 0]."""
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


@pytest.mark.parametrize("T", [1, 1024, 3072])
def test_mas_plan_covers_every_column(T):
    """For every N the kernel takes: an item is a cluster of at most 8
    blocks, each block owns 32 k adjacent columns (lane l of its chain warp
    the k columns from k l), every column below N is owned exactly once,
    every block owns one below N, and the block's shared memory fits the
    card."""
    for N in range(1, MAX_N + 1):
        plan = mas_plan(T, N)
        assert 1 <= plan.cluster <= MAX_CLUSTER and 1 <= plan.k <= MAX_K, (N, plan)
        W = 32 * plan.k
        cols = (np.arange(plan.cluster)[:, None, None] * W
                + plan.k * np.arange(32)[None, :, None] + np.arange(plan.k)[None, None, :])
        np.testing.assert_array_equal(np.sort(cols[cols < N]), np.arange(N))
        assert (plan.cluster - 1) * W < N, (N, plan)
        assert plan.smem == shared_bytes(T, plan.k) <= H100_SHARED, (N, plan)


def test_mas_plan_refuses_what_the_kernel_does_not_take():
    """N outside 1..1024, and T past what a block's shared memory holds,
    raise before any launch."""
    for N in (0, MAX_N + 1):
        with pytest.raises(ValueError, match="text positions"):
            mas_plan(64, N)
    with pytest.raises(ValueError, match="shared memory"):
        mas_plan(20000, MAX_N)
