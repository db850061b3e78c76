"""The port's flash attention (``ops/flash_attention.py``) and the flash
branch of its FFT block against the JAX package on the CPU.

On the CPU the port runs the kernels' plain version, ``flash_attention_plain``;
its oracle is JAX's ``mha_reference_no_custom_vjp`` with ``SegmentIds`` (the
Pallas kernel's own reference), output and gradients through ``jax.vjp``.
JAX's ``MultiHeadAttention`` takes its flash branch only on a TPU, so on the
CPU JAX's ``FFTBlock(use_flash=True)`` computes the dense branch: real rows
agree, and pad rows are zero in both after the non-pad mask.

Tolerances: f32, sums in another order: atol 1e-5 (attention), 2e-5 (the
block).  bf16: the port rounds the probabilities to bf16 before the product
with v, as the TPU kernel does, and the reference does not: 2e-2 of the
largest value (the attention), and for the block, whose projections round
to bf16 in both packages at other sums, 3e-2.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu.flash_attention import (
    SegmentIds,
    mha_reference_no_custom_vjp,
)

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.models.fft_block import FFTBlock as JFFT
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config, repo_path
from wavthruvec_pytorch_tpu_torch.models.fft_block import FFTBlock, flash_gate
from wavthruvec_pytorch_tpu_torch.ops import flash_attention as fa

BF16_RTOL = 2e-2
BLOCK_BF16_RTOL = 3e-2


def _bf16_values(a):
    """``a`` rounded to bf16 and back to f32 numpy (the same values in both
    packages)."""
    return torch.tensor(a).bfloat16().float().numpy()


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_mha_reference(dtype):
    """flash_attention (the plain version on the CPU, through the
    autograd.Function) == mha_reference_no_custom_vjp with segment ids, for
    the output and the three gradients: B = 2, H = 2, T = 256, D = 24, the
    second item padded from 200 on."""
    rng = np.random.default_rng(0)
    B, H, T, D = 2, 2, 256, 24
    q, k, v, dout = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, dout = (_bf16_values(a) for a in (q, k, v, dout))
    seg = np.ones((B, T), np.int32)
    seg[1, 200:] = 0
    scale = 1.0 / math.sqrt(D)

    def ref(q_, k_, v_):
        s = jnp.asarray(seg)
        return mha_reference_no_custom_vjp(q_, k_, v_, None, SegmentIds(q=s, kv=s), sm_scale=scale)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))

    tdt = getattr(torch, dtype)
    qkv = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    got = fa.flash_attention(*qkv, torch.tensor(seg), scale)
    assert got.dtype == tdt
    got.backward(torch.tensor(dout).to(tdt))
    pairs = [("out", got, want)] + [(f"d{n}", t.grad, g)
                                     for n, t, g in zip("qkv", qkv, want_grads)]
    for name, g, w in pairs:
        g, w = g.detach().float().numpy(), np.asarray(w)
        print(f"{dtype} {name}: max |port - JAX| {np.abs(g - w).max():.3g}, "
              f"relative to max |JAX| {_max_rel(g, w):.3g}")
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
        else:
            assert _max_rel(g, w) <= BF16_RTOL, name
    assert fa.flash_fwd.launches == fa.flash_bwd_dkv.launches == fa.flash_bwd_dq.launches == 0


def test_plain_lse_and_masking():
    """lse is the log of the masked softmax's denominator, and a pad query
    sees exactly the pad keys (segment semantics): checked against a direct
    f32 computation, atol 1e-5."""
    rng = np.random.default_rng(1)
    B, H, T, D = 1, 1, 128, 8
    q, k, v = (torch.tensor(rng.standard_normal((B, H, T, D)).astype(np.float32))
               for _ in range(3))
    seg = torch.ones(B, T, dtype=torch.int32)
    seg[0, 100:] = 0
    out, lse = fa.flash_attention_plain(q, k, v, seg, 0.5)
    s = (q @ k.transpose(-1, -2)) * 0.5
    same = (seg[:, :, None] == seg[:, None, :])[:, None]
    want_lse = torch.logsumexp(torch.where(same, s, -math.inf), dim=-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-5)
    p_pad = torch.softmax(s[0, 0, 110, 100:], dim=-1)
    np.testing.assert_allclose(out[0, 0, 110].numpy(), (p_pad @ v[0, 0, 100:]).numpy(), atol=1e-5)


@pytest.mark.parametrize("bad", ["float16", "meta"])
def test_wrapper_raises_on_other_dtypes_and_devices(bad):
    q = torch.zeros(1, 1, 64, 8, dtype=torch.float16 if bad == "float16" else torch.float32,
                    device="meta" if bad == "meta" else "cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16" if bad == "float16" else "device"):
        fa.flash_attention(q, q, q, torch.ones(1, 64, dtype=torch.int32, device=q.device), 1.0)


def _block_pair(T, dtype, seed, use_flash=True, n_head=2, d_k=16):
    """The port's and JAX's FFTBlock(d_model 32, d_inner 48, ``n_head``
    heads of ``d_k``, use_flash, dtype) on the same weights; a batch of 2
    whose second item is padded from 3/4 of T on."""
    rng = np.random.default_rng(seed)
    B, D = 2, 32
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    seq = np.ones((B, T), np.int32)
    seq[1, 3 * T // 4:] = 0
    non_pad = (seq != 0).astype(np.float32)[..., None]
    mask = np.broadcast_to((seq == 0)[:, None, :], (B, T, T))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jm = JFFT(D, 48, n_head, d_k, d_k, dropout=0.0, use_flash=use_flash, dtype=jdt)
    jargs = (jnp.asarray(x), jnp.asarray(non_pad), jnp.asarray(mask))
    jv = jm.init(jax.random.PRNGKey(seed), *jargs)
    want = np.asarray(jm.apply(jv, *jargs)[0].astype(jnp.float32))
    sd = weights._to_torch(weights._export(
        {"params": {"m": {"layer_stack_0": jax.tree_util.tree_map(np.asarray, jv["params"])}}},
        weights._fft_stack_spec("m", "m", 1)))
    tm = FFTBlock(D, 48, n_head, d_k, d_k, dropout=0.0, use_flash=use_flash,
                  dtype=torch.bfloat16 if dtype == "bfloat16" else None, device="cpu")
    tm.load_state_dict({k[len("m.layer_stack.0."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got, attn = tm.eval()(torch.tensor(x), torch.tensor(non_pad), torch.tensor(mask))
    return got.float().numpy(), attn, want, seq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_block_matches_jax(dtype):
    """FFTBlock(use_flash=True) at T = 256 (the gate passes: the port takes
    the flash branch) against JAX's, which takes the dense branch on the
    CPU: real rows atol 2e-5 in f32, 3e-2 of the largest value in bf16; pad
    rows are zero in both."""
    got, attn, want, seq = _block_pair(256, dtype, seed=2)
    assert tuple(attn.shape) == (2, 2, 0, 0)  # the flash branch ran
    real = seq.astype(bool)
    assert not got[~real].any() and not want[~real].any()
    err = np.abs(got[real] - want[real]).max()
    print(f"{dtype} flash FFTBlock vs JAX: real rows max |diff| {err:.3g}, "
          f"relative {_max_rel(got[real], want[real]):.3g}")
    if dtype == "float32":
        np.testing.assert_allclose(got[real], want[real], atol=2e-5)
    else:
        assert _max_rel(got[real], want[real]) <= BLOCK_BF16_RTOL


@pytest.mark.parametrize("d_k", [288, 448])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_flash_block_matches_jax(dtype, d_k):
    """FFTBlock(use_flash=True) with one head of d_k = 288 or 448 (the wide
    kernels' head dims on the card: 288 zero-padded to 320, 448 unpadded) at T = 256
    against JAX's ``MultiHeadAttention`` block, which takes its dense branch
    on the CPU, at ``test_flash_block_matches_jax``'s tolerances."""
    got, attn, want, seq = _block_pair(256, dtype, seed=5, n_head=1, d_k=d_k)
    assert tuple(attn.shape) == (2, 1, 0, 0)  # the flash branch ran
    real = seq.astype(bool)
    assert not got[~real].any() and not want[~real].any()
    print(f"{dtype} d_k={d_k} flash FFTBlock vs JAX: real rows max |diff| "
          f"{np.abs(got[real] - want[real]).max():.3g}, relative "
          f"{_max_rel(got[real], want[real]):.3g}")
    if dtype == "float32":
        np.testing.assert_allclose(got[real], want[real], atol=2e-5)
    else:
        assert _max_rel(got[real], want[real]) <= BLOCK_BF16_RTOL


@pytest.mark.parametrize("T,flash", [(3000, False), (128, False), (200, False), (256, True),
                                     (3072, True)])
def test_flash_gate(T, flash):
    """JAX's gate: d_v == d_k, T % 128 == 0 and T >= 256.  The dense branch
    returns the [B, H, T, T] probabilities, the flash branch [B, H, 0, 0]."""
    assert flash_gate(True, 16, 16, T) == flash
    assert not flash_gate(False, 16, 16, T) and not flash_gate(True, 16, 8, T)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((1, T, 8)).astype(np.float32))
    blk = FFTBlock(8, 16, 1, 8, 8, dropout=0.0, use_flash=True, device="cpu").eval()
    with torch.no_grad():
        _, attn = blk(x)
    assert tuple(attn.shape) == ((1, 1, 0, 0) if flash else (1, 1, T, T))


def test_dropout_guard():
    """A training forward with use_flash and dropout > 0 raises ValueError,
    even where the gate would not pass (T = 16), as JAX's does; dropout 0, or
    an eval forward, runs."""
    x = torch.zeros(1, 16, 32)
    blk = FFTBlock(32, 64, 2, 16, 16, dropout=0.1, use_flash=True, device="cpu")
    with pytest.raises(ValueError, match="attention-prob dropout"):
        blk.train()(x)
    blk.eval()(x)
    FFTBlock(32, 64, 2, 16, 16, dropout=0.0, use_flash=True, device="cpu").train()(x)
    FFTBlock(32, 64, 2, 16, 16, dropout=0.1, use_flash=False, device="cpu").train()(x)


def test_kernel_shape_rule():
    """``kernel_shape_ok`` takes every length the model's flash gate lets
    through at the head dim of both FFT stacks of the long-bucket config (an
    instantiated width, run unpadded), and any head dim in both dtypes: up
    to 256 on the templates' widths, past it on the wide kernels at the next
    multiple of 64 (their score-product stage); it rejects what the kernels
    do not take."""
    cfg = load_config(Text2VecConfig, repo_path("artifacts", "flash_longbucket", "flash",
                                                "longbucket", "config.json"))
    dims = {cfg.encoder_output_dim // cfg.encoder_head, cfg.decoder_model_dim // cfg.encoder_head}
    assert dims == {224} and 224 in fa.WIDTHS and fa.kernel_width(224) == 224
    gated = [T for T in range(0, 4097, 64) if flash_gate(True, 224, 224, T)]
    assert gated[0] == 256 and {768, 3072} <= set(gated)
    for T in gated:
        for B in (1, 16):
            for dtype in (torch.bfloat16, torch.float32):
                assert fa.kernel_shape_ok(B, 2, T, 224, dtype), (B, T, dtype)
    for D in (1, 12, 48, 64, 96, 128, 200, 256, 257, 288, 300, 448, 512, 1024, 1100):
        for dtype in (torch.bfloat16, torch.float32):
            assert fa.kernel_shape_ok(1, 2, 64, D, dtype), (D, dtype)
    assert [fa.kernel_width(D) for D in (1, 64, 65, 128, 129, 224, 225, 256)] == \
        [64, 64, 128, 128, 224, 224, 256, 256]
    assert [fa.kernel_width(D) for D in (257, 288, 300, 384, 385, 448, 512, 1024, 1100)] == \
        [320, 320, 320, 384, 448, 448, 512, 1024, 1152]
    assert not any(fa.wide(D) for D in (1, 224, 256)) and all(fa.wide(D) for D in (257, 448))
    assert fa.kernels_for(256) == (fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq)
    assert fa.kernels_for(288) == (fa.flash_fwd_wide, fa.flash_bwd_dkv_wide,
                                   fa.flash_bwd_dq_wide)
    for bad in ((1, 2, 96, 224, torch.bfloat16), (0, 2, 64, 224, torch.bfloat16),
                (1, 2, 96, 288, torch.bfloat16), (1, 2, 100, 448, torch.float32),
                (1, 2, 64, 0, torch.float32), (1, 2, 64, 224, torch.float16),
                (1, 2, 64, 448, torch.float16)):
        assert not fa.kernel_shape_ok(*bad), bad


def test_f32_splits():
    """The f32 forward's key splits: every split non-empty and at most 32; a
    single split where the query tiles alone fill the card; at serving's
    shapes (B H = 2, T = 768 and 3072) the blocks fill more than 70% of an
    H100's 132 SMs in every wave, where one split would leave 91% (T = 768)
    or 64% (T = 3072) of them idle."""
    for BH, T in ((2, 768), (2, 3072), (2, 256), (4, 320), (32, 3072), (32, 768), (1, 64)):
        s = fa.f32_splits(BH, T, 132)
        tiles = T // 32
        per = -(-tiles // s)
        assert 1 <= s <= min(32, tiles) and -(-tiles // per) == s, (BH, T, s)
    assert fa.f32_splits(32, 3072, 132) == 1
    for T in (768, 3072):
        s = fa.f32_splits(2, T, 132)
        blocks = 2 * (T // 128) * s
        waves = -(-blocks // 132)
        assert blocks / (waves * 132) > 0.7, (T, s, blocks)


def test_wide_chunk_plan():
    """The wide kernels' output chunks (a block each) at every head dim from
    257 to 1024: the padded width W is the next multiple of ``WIDE_PAD``;
    its chunks cover W in order, none is empty or wider than 256 columns
    (wgmma's widest N), every one is a multiple of the 32-column TMA box,
    all but the last are 256 wide, and D <= 512 takes at most two."""
    assert (fa.WIDE_PAD, fa.WIDE_CHUNK) == (64, 256)
    for D in range(257, 1025):
        W = fa.kernel_width(D)
        assert W % fa.WIDE_PAD == 0 and D <= W < D + fa.WIDE_PAD, (D, W)
        chunks = fa.wide_chunks(W)
        assert sum(chunks) == W and len(chunks) == -(-W // 256), (D, chunks)
        assert all(0 < c <= 256 and c % 32 == 0 for c in chunks), (D, chunks)
        assert all(c == 256 for c in chunks[:-1]), (D, chunks)
        assert len(chunks) <= 2 or D > 512, (D, chunks)
    assert fa.wide_chunks(448) == [256, 192] and fa.wide_chunks(320) == [256, 64]
    assert fa.wide_chunks(512) == [256, 256] and fa.wide_chunks(768) == [256] * 3


@pytest.mark.parametrize("BH, T", [(1, 768), (1, 3072), (2, 3072), (16, 3072), (1, 64), (4, 320)])
def test_wide_f32_splits(BH, T):
    """The wide f32 forward's key splits (``f32_splits`` with its chunk
    count: a block per 128 query rows, chunk and split): every split is
    non-empty and at most 32 at every wide width up to 1024; at the one-head
    serving shapes (B H = 1, T = 768 and 3072, D = 448: two chunks) the
    blocks fill more than 70% of an H100's 132 SMs in every wave, where one
    split gives 12 or 48 blocks."""
    tiles = T // 32
    for W in range(320, 1025, 64):
        chunks = len(fa.wide_chunks(W))
        s = fa.f32_splits(BH, T, 132, chunks)
        per = -(-tiles // s)
        assert 1 <= s <= min(32, tiles) and -(-tiles // per) == s, (W, s)
    if BH == 1 and T in (768, 3072):
        s = fa.f32_splits(BH, T, 132, len(fa.wide_chunks(448)))
        blocks = (T // 128) * 2 * s
        assert s > 1 and blocks / (-(-blocks // 132) * 132) > 0.7, (T, s, blocks)


@pytest.mark.parametrize("name", ["flash_fwd_wide", "flash_bwd_dkv_wide", "flash_bwd_dq_wide"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_kernel_blocks(name, dtype):
    """Each wide kernel's blocks along blockIdx.z (``wide_blocks``) at every
    head dim from 257 to 1024: together they cover the padded width W in
    order; every kernel but the f32 dQ takes ``wide_chunks(W)`` (chunks of
    256), one a block, but the bf16 dQ two a block, so at D <= 512 one block
    of each query tile computes the scores once for all of dQ; the f32 dQ
    takes ``dq_f32_chunks(W)``: W in as few chunks of at most
    ``DQ_F32_COLS`` = 512 as will do, multiples of 64 all as wide as the
    first but the last, so up to D = 512 one chunk computes the scores once
    for all of dQ."""
    f32_dq = name == "flash_bwd_dq_wide" and dtype == torch.float32
    for D in range(257, 1025):
        W = fa.kernel_width(D)
        blocks = fa.wide_blocks(name, dtype, W)
        flat = [c for blk in blocks for c in blk]
        if f32_dq:
            assert flat == fa.dq_f32_chunks(W) and len(flat) == -(-W // 512), (D, blocks)
            assert all(c % 64 == 0 and c <= 512 for c in flat), (D, blocks)
            assert all(c == flat[0] for c in flat[:-1]) and flat[-1] <= flat[0], (D, blocks)
            assert len(flat) == 1 or D > 512, (D, blocks)
        else:
            assert flat == fa.wide_chunks(W, fa.WIDE_CHUNK), (D, blocks)
        per_block = 2 if name == "flash_bwd_dq_wide" and dtype == torch.bfloat16 else 1
        assert all(len(blk) == per_block for blk in blocks[:-1]), (D, blocks)
        assert 1 <= len(blocks[-1]) <= per_block and all(c % 32 == 0 for c in flat), (D, blocks)
        if per_block == 2 and W <= 512:
            assert len(blocks) == 1, (D, blocks)
    assert fa.wide_blocks("flash_bwd_dq_wide", torch.bfloat16, 448) == [[256, 192]]
    assert fa.wide_blocks("flash_bwd_dq_wide", torch.bfloat16, 768) == [[256, 256], [256]]
    assert fa.wide_blocks("flash_bwd_dq_wide", torch.float32, 448) == [[448]]
    assert fa.wide_blocks("flash_bwd_dq_wide", torch.float32, 576) == [[320], [256]]
    assert fa.wide_blocks("flash_bwd_dq_wide", torch.float32, 768) == [[384], [384]]
    assert fa.wide_blocks("flash_bwd_dkv_wide", dtype, 448) == [[256], [192]]


@pytest.mark.parametrize("BH, T", [(1, 768), (1, 3072), (8, 3072), (2, 3072), (1, 64), (4, 320)])
def test_wide_dkv_f32_splits(BH, T):
    """The wide f32 dK/dV's query splits (``dkv_f32_splits``: a block per 32
    keys, chunk and split, 16-query tiles): every split is non-empty and at
    most 32 at every wide width up to 1024; at one head of 3072 or 768
    frames at D = 448 (two chunks: 192 or 48 blocks unsplit) the blocks fill
    at least 70% of an H100's 132 SMs in every wave; at the f32 training
    batch [8, 1, 3072, 448] (1536 blocks) there is one split."""
    tiles = T // 16
    for W in range(320, 1025, 64):
        chunks = len(fa.wide_blocks("flash_bwd_dkv_wide", torch.float32, W))
        s = fa.dkv_f32_splits(BH, T, 132, chunks)
        per = -(-tiles // s)
        assert 1 <= s <= min(32, tiles) and -(-tiles // per) == s, (W, s)
    s = fa.dkv_f32_splits(BH, T, 132, 2)
    blocks = BH * (T // 32) * 2 * s
    if BH == 1 and T in (768, 3072):
        assert s > 1 and blocks / (-(-blocks // 132) * 132) >= 0.7, (T, s, blocks)
    if (BH, T) == (8, 3072):
        assert s == 1


@pytest.mark.parametrize("BH, T", [(1, 768), (1, 3072), (8, 3072), (2, 3072), (1, 64), (4, 320)])
def test_wide_dq_f32_splits(BH, T):
    """The wide f32 dQ's key splits (``dq_f32_splits``: a block per 32
    queries, chunk and split, 16-key tiles): every split is non-empty and
    at most 32 at every wide width up to 1024; at one head of 3072 or 768
    frames at D = 448 (one chunk: 96 or 24 blocks unsplit) the blocks fill
    at least 70% of an H100's 132 SMs in every wave; at the f32 training
    batch [8, 1, 3072, 448] (768 blocks) there is one split."""
    tiles = T // 16
    for W in range(320, 1025, 64):
        chunks = len(fa.wide_blocks("flash_bwd_dq_wide", torch.float32, W))
        s = fa.dq_f32_splits(BH, T, 132, chunks)
        per = -(-tiles // s)
        assert 1 <= s <= min(32, tiles) and -(-tiles // per) == s, (W, s)
    s = fa.dq_f32_splits(BH, T, 132, 1)
    blocks = BH * (T // 32) * s
    if BH == 1 and T in (768, 3072):
        assert s > 1 and blocks / (-(-blocks // 132) * 132) >= 0.7, (T, s, blocks)
    if (BH, T) == (8, 3072):
        assert s == 1


@pytest.mark.parametrize("D", [12, 48, 96, 300, 448, 700, 768])
def test_head_dim_padding_is_exact(D):
    """What the wrappers do for a head dim outside ``WIDTHS`` (and past 256
    not a multiple of 64): zero-pad q, k, v and dout to ``kernel_width(D)``,
    keep sm_scale = 1/sqrt(D), slice the output and gradients back.  On the
    plain version in f32 (B = 2, H = 2, T = 128, the second item padded from
    90 on) the output, lse and the three gradients equal the unpadded ones
    within 1e-6 (2e-6 past 256).  Past 256 the wide kernels run 300 at 320
    and 700 at 704; 448 and 768, multiples of 64, run unpadded."""
    rng = np.random.default_rng(D)
    B, H, T = 2, 2, 128
    W = fa.kernel_width(D)
    assert W == D if fa.wide(D) and D % fa.WIDE_PAD == 0 else W > D
    q, k, v, dout = (torch.tensor(rng.standard_normal((B, H, T, D)).astype(np.float32))
                     for _ in range(4))
    seg = torch.ones(B, T, dtype=torch.int32)
    seg[1, 90:] = 0
    scale = 1.0 / math.sqrt(D)

    def run(width):
        qkv = [torch.nn.functional.pad(t, (0, width - D)).requires_grad_() for t in (q, k, v)]
        out, lse = fa.flash_attention_plain(*qkv, seg, scale)
        grads = torch.autograd.grad(out, qkv, torch.nn.functional.pad(dout, (0, width - D)))
        return [out[..., :D], lse] + [g[..., :D] for g in grads], out[..., D:]

    want, _ = run(D)
    got, pad_out = run(W)
    assert not pad_out.any()
    # past 256 the CPU's f32 GEMM may block the padded sums otherwise than
    # the unpadded ones: ~10 ulp of the largest values (~2) apart
    atol = 1e-6 if D <= fa.WIDTHS[-1] else 2e-6
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=atol, err_msg=name)


def test_backward_inputs_shared():
    """``backward_inputs``, made once a backward for both kernels: q, k, v
    and dout in the kernels' contiguous [B, T, H, D] layout (both dtypes
    zero-padded to ``kernel_width(D)``, past 256 to a multiple of 64 for
    the wide kernels), int32 segment ids, and delta = rowsum(dout * out) in
    f32 (against float64, 1e-5 of the row's sum of |terms|).  The kernels
    refuse CPU inputs."""
    rng = np.random.default_rng(4)
    B, H, T, D = 2, 2, 64, 224
    q, k, v, out, dout = (torch.tensor(rng.standard_normal((B, H, T, D)), dtype=torch.bfloat16)
                          for _ in range(5))
    seg = torch.tensor(rng.integers(0, 2, (B, T)))
    lse = torch.tensor(rng.standard_normal((B, H, T)), dtype=torch.float32)
    ins = fa.backward_inputs(q, k, v, seg, out, lse, dout)
    terms = dout.double() * out.double()
    assert ins.delta.dtype == torch.float32 and tuple(ins.delta.shape) == (B, H, T)
    err = (ins.delta.double() - terms.sum(-1)).abs() / terms.abs().sum(-1)
    assert float(err.max()) <= 1e-5
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        got = getattr(ins, name)
        assert got.is_contiguous() and torch.equal(got, t.transpose(1, 2)), name
    assert ins.seg.dtype == torch.int32 and torch.equal(ins.seg, seg.to(torch.int32))
    assert torch.equal(ins.lse, lse) and ins.shape == (B, H, T, D)
    small = fa.backward_inputs(*(t[..., :48] for t in (q, k, v)), seg, out[..., :48], lse,
                               dout[..., :48])
    assert small.shape == (B, H, T, 48) and small.q.shape == (B, T, H, 64)
    assert torch.equal(small.q[..., :48], q[..., :48].transpose(1, 2))
    assert not small.q[..., 48:].any() and not small.dout[..., 48:].any()
    f32 = fa.backward_inputs(*(t[..., :48].float() for t in (q, k, v)), seg,
                             out[..., :48].float(), lse, dout[..., :48].float())
    assert f32.q.shape == (B, T, H, 64)  # zero-padded to kernel_width(48), as bf16
    assert torch.equal(f32.q[..., :48], q[..., :48].float().transpose(1, 2))
    assert not f32.q[..., 48:].any() and not f32.dout[..., 48:].any()
    wide = [torch.tensor(rng.standard_normal((B, H, T, 300)), dtype=torch.bfloat16)
            for _ in range(5)]
    wins = fa.backward_inputs(*wide[:3], seg, wide[3], lse, wide[4])
    assert wins.shape == (B, H, T, 300)
    for name, t in (("q", wide[0]), ("k", wide[1]), ("v", wide[2]), ("dout", wide[4])):
        got = getattr(wins, name)
        assert got.shape == (B, T, H, 320) and got.is_contiguous(), name
        assert torch.equal(got[..., :300], t.transpose(1, 2)) and not got[..., 300:].any(), name
    want_delta = (wide[4].double() * wide[3].double()).sum(-1)
    assert float(((wins.delta.double() - want_delta).abs()).max()) <= 1e-5 * float(
        (wide[4].double() * wide[3].double()).abs().sum(-1).max())
    with pytest.raises(ValueError, match="device"):
        fa.flash_bwd_dkv_wide(wins, 0.1)
    with pytest.raises(ValueError, match="device"):
        fa.flash_bwd_dkv(ins, 0.1)
    with pytest.raises(ValueError, match="device"):
        fa.flash_bwd_dq(ins, 0.1)


@pytest.mark.parametrize("d_k, dtype", [(288, torch.bfloat16), (320, None),
                                        (448, torch.bfloat16)])
def test_flash_block_on_card_refuses_head_dim(d_k, dtype):
    """A flash block built for a CUDA device takes a head dim past 256 (the
    wide kernels run it): on a machine without a card it fails only where
    torch first allocates on the card, with torch's own error, not the
    block's; ``head_dim_ok`` takes it in both dtypes, and so does the CPU
    block."""
    try:
        FFTBlock(2 * d_k, 64, 2, d_k, d_k, dropout=0.0, use_flash=True, dtype=dtype,
                 device="cuda")
    except (AssertionError, RuntimeError) as err:  # torch's, without a card
        assert "d_k" not in str(err)
    for D in (1, 48, 224, 256, d_k):
        assert fa.head_dim_ok(D, torch.bfloat16) and fa.head_dim_ok(D, torch.float32)
    FFTBlock(2 * d_k, 64, 2, d_k, d_k, dropout=0.0, use_flash=True, dtype=dtype, device="cpu")


@pytest.mark.parametrize("encoder_dim, decoder_dim, head", [(576, 448, 2), (448, 576, 2),
                                                           (256, 256, 1)])
def test_flash_config_past_head_dim_256_refused_on_cpu(tmp_path, encoder_dim, decoder_dim,
                                                        head):
    """A Text2Vec config with flash_attention=True whose head dim exceeds 256
    passes ``check_ported`` and builds: both FFT stacks take d_k = d_model //
    encoder_head, d_model the encoder's output (``encoder_dim`` plus
    ``n_speaker_dim`` with the multi-speaker condition, 192 here) or the
    decoder's; (256, 256, 1) is the long-bucket config's widths at one head,
    d_k 448, where ``encoder_dim // head`` alone would say 256."""
    from wavthruvec_pytorch_tpu_torch.config import check_ported
    from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
    raw = dict(encoder_dim=encoder_dim, decoder_dim=decoder_dim, encoder_head=head,
               decoder_head=head, flash_attention=True, n_speaker_dim=192,
               encoder_n_layer=1, decoder_n_layer=1, encoder_conv1d_filter_size=32,
               decoder_conv1d_filter_size=32, n_feat_dim=32, spk_channel=32)
    path = tmp_path / "t2v.json"
    path.write_text(json.dumps(raw))
    cfg = load_config(Text2VecConfig, str(path))
    assert cfg.use_multi_speaker_condition
    d_ks = {cfg.encoder_output_dim // head, cfg.decoder_model_dim // head}
    assert min(d_ks) > 256
    check_ported(cfg)
    model = Text2Vec(cfg, device="cpu")
    built = {model.encoder.layer_stack[0].slf_attn.d_k,
             model.decoder.layer_stack[0].slf_attn.d_k}
    assert built == d_ks
    assert all(stack.layer_stack[0].slf_attn.use_flash for stack in (model.encoder,
                                                                      model.decoder))


def test_flash_block_on_card_takes_padded_head_dim():
    """A bf16 flash block at d_k = 48 (run zero-padded to 64 on the card)
    passes the head-dim check at construction on a CUDA device; on a machine
    without one it then fails where torch first allocates on the card, with
    torch's own error, not the block's."""
    try:
        FFTBlock(96, 64, 2, 48, 48, dropout=0.0, use_flash=True, dtype=torch.bfloat16,
                 device="cuda")
    except NotImplementedError as err:
        pytest.fail(f"the head-dim check refused d_k = 48: {err}")
    except (AssertionError, RuntimeError) as err:  # torch's, without a card
        assert "d_k" not in str(err)
