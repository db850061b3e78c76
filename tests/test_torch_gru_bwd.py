"""The BiGRU's backward recurrence, ``ops/gru.py`` ``gru_bwd_loop`` (the
kernel ``csrc/gru_bwd.cu`` on CUDA tensors), against the JAX package's
custom VJP on the CPU, and the kernel's route planner.

The same seeded numpy inputs go through both packages.  JAX's
``_gru_stacked_bwd`` (models/layers.py:795-840) is reached through
``jax.vjp`` of ``gru_stacked`` in "scan" and in "pallas" (its Pallas forward
in interpret mode on the CPU).  On the port's side ``gru_bwd`` on CPU tensors
runs ``gru_bwd_loop_plain``, the kernel's plain version, between the matmul
that recomputes gh and those of the weight gradients; the input
projection's gradients follow from dgi as JAX's einsums take them.  The
kernel itself is held to ``gru_bwd_loop_plain`` on the card by
``chip_smoke.py``.

Tolerance: f32 on both sides, sums reassociated: atol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu_torch.ops import gru, kernel_build

BWD_ATOL = 2e-5
H100_SMS, H100_SMEM = 132, 232448
# clusters of C blocks an H100 80GB HBM3 holds at once at one block an SM
# (cudaOccupancyMaxActiveClusters, as chip_smoke.py phase 10 prints them)
H100_CLUSTERS = {4: 30, 2: 66}


def _inputs(D, B, T, C, H, seed):
    """xs, w_ih, w_hh, b_ih, b_hh (torch's uniform init) and a cotangent dy,
    numpy."""
    rng = np.random.default_rng(seed)
    bound = 1.0 / np.sqrt(H)
    xs = (rng.standard_normal((D, B, T, C)) * 0.5).astype(np.float32)
    w_ih, w_hh = (rng.uniform(-bound, bound, (D, n, 3 * H)).astype(np.float32) for n in (C, H))
    b_ih, b_hh = (rng.uniform(-bound, bound, (D, 3 * H)).astype(np.float32) for _ in range(2))
    dy = rng.standard_normal((D, B, T, H)).astype(np.float32)
    return (xs, w_ih, w_hh, b_ih, b_hh), dy


def _counters():
    return (gru.gru_bwd_loop.launches, gru.gru_bwd_loop.step_launches,
            gru.gru_bwd_loop.time_steps)


@pytest.mark.parametrize("impl, H", [("scan", 48), ("pallas", 128)])
def test_bwd_matches_jax_vjp(impl, H):
    """gru_bwd on CPU tensors (gru_bwd_loop_plain and the matmuls) == JAX's
    _gru_stacked_bwd through jax.vjp of gru_stacked(impl) at D = 2, B = 2,
    T = 12: the five gradients atol 2e-5, the port's hprev from the forward
    of the numerics impl selects (f32 for "scan", bf16 for "pallas" at H =
    128, as JAX's Pallas kernel).  On the CPU the wrapper launches nothing
    and equals gru_bwd_plain bit for bit."""
    D, B, T, C = 2, 2, 12, 32
    args, dy = _inputs(D, B, T, C, H, seed=H)
    _, vjp = jax.vjp(lambda *a: jl.gru_stacked(*a, impl), *(jnp.asarray(a) for a in args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    xs, w_ih, w_hh, b_ih, b_hh = (torch.tensor(a) for a in args)
    gi = (torch.matmul(xs, w_ih[:, None]) + b_ih[:, None, None]).contiguous()
    ys = gru.gru_fwd_plain(gi, w_hh, b_hh, gru.gru_numerics(impl, D, B, H))
    hprev = torch.cat([ys.new_zeros(D, B, 1, H), ys[:, :, :-1]], dim=2)
    before = _counters()
    dgi, dw_hh, db_hh = gru.gru_bwd(torch.tensor(dy), gi, hprev, w_hh, b_hh)
    assert _counters() == before
    for a, b in zip((dgi, dw_hh, db_hh), gru.gru_bwd_plain(torch.tensor(dy), gi, hprev, w_hh,
                                                          b_hh)):
        assert torch.equal(a, b)
    got = (torch.einsum("dbtg,dcg->dbtc", dgi, w_ih), torch.einsum("dbtc,dbtg->dcg", xs, dgi),
           dw_hh, dgi.sum(dim=(1, 2)), db_hh)
    for name, g, ref in zip(("xs", "w_ih", "w_hh", "b_ih", "b_hh"), got, want):
        print(f"{impl} d{name}: max |port - JAX| {np.abs(g.numpy() - ref).max():.3g} "
              f"(max |g| {np.abs(ref).max():.3g})")
        np.testing.assert_allclose(g.numpy(), ref, atol=BWD_ATOL, err_msg=name)


@pytest.mark.parametrize("B", [1, 2, 8, 16, 40, 64])
def test_bwd_plan_persistent_at_cbhg_shapes(B):
    """At D = 2, H = 1024 on an H100 (132 SMs, 232,448 bytes a block) the
    backward is one persistent launch at every batch the training paths
    use (1, 2, 8, 16), at the f32 forward's persistent limit (40) and up to
    64 (four passes of 16 rows): 16 units a block, 128 blocks, the kernel's
    shared memory whatever B, in clusters of 2 (32 clusters of 4 do not fit
    the card at once)."""
    plan = gru.gru_bwd_plan(2, B, 1024, H100_SMS, H100_SMEM, H100_CLUSTERS)
    assert plan == gru.GRUPlan("persistent", 128, 16, gru.persistent_bwd_smem(16, 1024), 2)
    assert plan.smem <= H100_SMEM


@pytest.mark.parametrize("D, B, H, n_sm, smem", [
    (2, 65, 1024, H100_SMS, H100_SMEM),   # a fifth pass of 16 rows
    (2, 4, 2048, H100_SMS, H100_SMEM),    # 8 units: 512 blocks; 16: the rows do not fit
    (4, 1, 1024, H100_SMS, H100_SMEM),    # 256 blocks
    (2, 16, 1024, 100, H100_SMEM),        # fewer SMs than blocks
    (2, 16, 1024, H100_SMS, 200_000),     # less shared memory a block
])
def test_bwd_plan_steps_where_it_does_not_fit(D, B, H, n_sm, smem):
    """Where the blocks outnumber the SMs, the rows of w_hh overflow a
    block's shared memory or the batch needs more passes than a thread's
    registers hold, the backward takes the one-launch-a-step route."""
    plan = gru.gru_bwd_plan(D, B, H, n_sm, smem, H100_CLUSTERS)
    assert plan == gru.GRUPlan("steps", D * H // 8, 8, 0)


def test_persistent_bwd_smem_bytes():
    """The persistent kernel's shared memory: the pair's 2U rows of w_hh over
    half the 3H columns (U x 3H f32), two dgh stages of 4096 floats, the
    partner's sums [2, 16, U] and two 8-byte mbarriers.  At H = 1024:
    196,608 + 32,768 + 2,048 + 16 (the next U, 24, has no instance and
    would not fit an H100's block); 8 units at H = 512."""
    assert gru.persistent_bwd_smem(16, 1024) == 196_608 + 32_768 + 2_048 + 16 == 231_440
    assert gru.persistent_bwd_smem(8, 512) == 49_152 + 32_768 + 1_024 + 16 == 82_960
    assert gru.persistent_bwd_smem(24, 1024) == 294_912 + 32_768 + 3_072 + 16 > H100_SMEM
    assert gru.BWD_UNITS == (8, 16)


def test_bwd_wrapper_takes_plain_only_on_cpu(monkeypatch):
    """gru_bwd_loop runs gru_bwd_loop_plain on CPU tensors and launches
    nothing; on any other device it raises; gru_bwd_steps takes no CPU
    tensor.  A call off the CPU reaches the kernel or raises: with the
    device check passed (meta tensors standing in for CUDA ones) and the
    library's load failing, it raises and never takes the plain loop."""
    (_, _, w_hh, _, b_hh), dy = _inputs(2, 1, 5, 8, 16, seed=3)
    rng = np.random.default_rng(4)
    gi = torch.tensor(rng.standard_normal((2, 1, 5, 48)).astype(np.float32))
    hprev = torch.tensor(rng.standard_normal((2, 1, 5, 16)).astype(np.float32))
    w_hh, b_hh = torch.tensor(w_hh), torch.tensor(b_hh)
    gh = (torch.matmul(hprev, w_hh[:, None]) + b_hh[:, None, None]).contiguous()
    args = (torch.tensor(dy), gi, gh, hprev, w_hh)
    before = _counters()
    for a, b in zip(gru.gru_bwd_loop(*args), gru.gru_bwd_loop_plain(*args)):
        assert torch.equal(a, b)
    assert _counters() == before
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="unsupported device"):
        gru.gru_bwd_loop(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gru.gru_bwd_steps(*args)

    def no_library(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}")

    def plain(*a):
        raise AssertionError("a tensor off the CPU took the plain loop")

    monkeypatch.setattr(gru, "_checked_bwd_shape", lambda dys, *a: tuple(dys.shape))
    monkeypatch.setattr(gru, "device_limits", lambda device: (H100_SMS, H100_SMEM))
    monkeypatch.setattr(kernel_build, "load", no_library)
    monkeypatch.setattr(gru, "gru_bwd_loop_plain", plain)
    with pytest.raises(RuntimeError, match="cannot build gru_bwd"):
        gru.gru_bwd_loop(*meta)
    assert _counters() == before
