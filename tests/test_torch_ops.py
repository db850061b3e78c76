"""Parity of the PyTorch port's ops against the JAX package on the CPU.

The kernels' plain versions stand in for the CUDA kernels here (a CPU tensor
takes the plain version); the kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.models.layers import BiGRU as JaxBiGRU
from wavthruvec_pytorch_tpu.ops import length_regulator as jlr
from wavthruvec_pytorch_tpu.ops import masking as jmask
from wavthruvec_pytorch_tpu.ops import positional as jpos
from wavthruvec_pytorch_tpu.ops.fused_resblock import conv_residual_reference
from wavthruvec_pytorch_tpu.ops.gru_pallas import gru_fwd_pallas
from wavthruvec_pytorch_tpu_torch.models.layers import BiGRU
from wavthruvec_pytorch_tpu_torch.ops import length_regulator as tlr
from wavthruvec_pytorch_tpu_torch.ops import masking as tmask
from wavthruvec_pytorch_tpu_torch.ops import positional as tpos
from wavthruvec_pytorch_tpu_torch.ops.fused_resblock import (
    conv_residual_plain,
    fused_conv_residual,
)
from wavthruvec_pytorch_tpu_torch.ops.gru import (
    gru_fwd,
    gru_fwd_plain,
    gru_fwd_plan,
    gru_fwd_steps,
    persistent_smem,
)

# an H100's SMs and the shared memory a block may opt into
H100_SMS, H100_SMEM = 132, 232448
FUSED_ATOL = 1e-4  # the card's kernel-vs-plain tolerance of the unit (chip_smoke.py)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.array(a), dtype=dtype)


def test_masking_exact():
    lengths = np.array([3, 7, 0, 5], np.int32)
    np.testing.assert_array_equal(
        tmask.get_mask_from_lengths(_t(lengths, torch.int64), 7).numpy(),
        np.asarray(jmask.get_mask_from_lengths(jnp.asarray(lengths), 7)))
    np.testing.assert_array_equal(
        tmask.positions_from_lengths(_t(lengths, torch.int64), 9).numpy(),
        np.asarray(jmask.positions_from_lengths(jnp.asarray(lengths), 9)))
    seq = np.array([[4, 5, 0, 0], [7, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        tmask.get_non_pad_mask(_t(seq, torch.int64)).numpy(),
        np.asarray(jmask.get_non_pad_mask(jnp.asarray(seq))))
    np.testing.assert_array_equal(
        tmask.get_attn_key_pad_mask(_t(seq, torch.int64), _t(seq, torch.int64)).numpy(),
        np.asarray(jmask.get_attn_key_pad_mask(jnp.asarray(seq), jnp.asarray(seq))))


@pytest.mark.parametrize("n_position,d_hid", [(51, 24), (3001, 448)])
def test_sinusoid_table_exact(n_position, d_hid):
    np.testing.assert_array_equal(
        tpos.sinusoid_encoding_table(n_position, d_hid, padding_idx=0),
        jpos.sinusoid_encoding_table(n_position, d_hid, padding_idx=0))
    # the in-graph twin the JAX models use agrees to f32 rounding of the angle
    np.testing.assert_allclose(
        tpos.sinusoid_encoding_table(n_position, d_hid, padding_idx=0),
        np.asarray(jpos.sinusoid_encoding_table_jnp(n_position, d_hid, padding_idx=0)),
        atol=2e-3)


@pytest.mark.parametrize("max_frames", [5, 16, 40])
def test_expand_by_durations_exact(max_frames):
    rng = np.random.default_rng(max_frames)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    dur = rng.integers(0, 5, (3, 6)).astype(np.int32)
    dur[2] = 0  # an item with no frames at all
    out, total = tlr.expand_by_durations(_t(x), _t(dur, torch.int64), max_frames)
    jout, jtotal = jlr.expand_by_durations(jnp.asarray(x), jnp.asarray(dur), max_frames)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # total is not clamped to max_frames
    np.testing.assert_array_equal(total.numpy(), np.asarray(jtotal))


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", [16, 32, 128, 256])
def test_fused_unit_plain_matches_jax_reference(C, k, d):
    """Plain version of the ResBlock2 kernel == conv_residual_reference,
    f32, atol 2e-5 (tests/test_ops.py's tolerance for the same op)."""
    rng = np.random.default_rng(C * 100 + k * 10 + d)
    B, T = 2, 48
    x = (rng.standard_normal((B, T, C)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((k, C, C)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(C) * 0.01).astype(np.float32)
    got = fused_conv_residual(_t(x), _t(w), _t(b), dilation=d).numpy()
    for i in range(B):
        want = np.asarray(conv_residual_reference(
            jnp.asarray(x[i]), jnp.asarray(w), jnp.asarray(b), dilation=d))
        np.testing.assert_allclose(got[i], want, atol=2e-5)


def test_fused_unit_wrapper_takes_plain_only_on_cpu():
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((1, 10, 16)))
    w = _t(rng.standard_normal((3, 16, 16)) * 0.1)
    b = _t(rng.standard_normal(16))
    before = fused_conv_residual.launches
    torch.testing.assert_close(fused_conv_residual(x, w, b, dilation=3),
                               conv_residual_plain(x, w, b, dilation=3), rtol=0, atol=0)
    assert fused_conv_residual.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError):
        fused_conv_residual(x.to("meta"), w.to("meta"), b.to("meta"))


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """a with its low 13 mantissa bits cleared: the TF32 value the tensor
    cores read from an f32 register."""
    return (a.view(torch.int32) & -8192).view(torch.float32)


def test_fused_unit_3xtf32_split_holds_f32_tolerance(capsys):
    """The kernel's arithmetic, emulated in torch at one full-size unit
    (C = 256, k = 11, d = 3, T = 512, weights at the Generator's init scale):
    lrelu(x) and w each split into hi (TF32) and lo = x - hi (read as TF32),
    summed as lo hi + hi lo + hi hi in f32.  It lies within FUSED_ATOL of
    ``conv_residual_plain``; one TF32 product (hi hi alone) is printed, not
    asserted, as the record of why the split is needed."""
    rng = np.random.default_rng(11)
    C, k, d, T = 256, 11, 3, 512
    x = _t(rng.standard_normal((1, T, C)))
    w = _t(rng.standard_normal((k, C, C)) * 0.01)
    b = _t(rng.standard_normal(C) * 0.01)
    want = conv_residual_plain(x, w, b, dilation=d)

    def conv(a, wk):
        pad = (k * d - d) // 2
        return torch.nn.functional.conv1d(a.transpose(1, 2), wk.permute(2, 1, 0), padding=pad,
                                          dilation=d).transpose(1, 2)

    a = torch.nn.functional.leaky_relu(x, 0.1)
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    three = conv(a_lo, w_hi) + conv(a_hi, w_lo) + conv(a_hi, w_hi) + b + x
    one = conv(a_hi, w_hi) + b + x
    err3 = float((three - want).abs().max())
    err1 = float((one - want).abs().max())
    with capsys.disabled():
        print(f"\nfused unit C={C} k={k} d={d} T={T}: 3xTF32 max |err| {err3:.2e}, "
              f"one TF32 product {err1:.2e} (FUSED_ATOL {FUSED_ATOL})")
    assert err3 <= FUSED_ATOL


@pytest.mark.parametrize("B", [1, 2, 16])
def test_gru_plan_persistent_at_cbhg_shapes(B):
    """At the CBHG's D = 2, H = 1024 the planner picks one persistent launch
    on an H100: 16 units a block (64 blocks a direction), the block's 48
    rows of bf16 w_hh (98,304 bytes) resident, within the card's SMs and a
    block's shared memory."""
    plan = gru_fwd_plan(2, B, 1024, H100_SMS, H100_SMEM)
    assert plan.route == "persistent"
    assert plan.blocks <= H100_SMS and plan.smem <= H100_SMEM
    assert (plan.units, plan.blocks) == (16, 128)
    assert plan.smem == persistent_smem(16, B, 1024) >= 3 * 16 * 1024 * 2


@pytest.mark.parametrize("D, B, H", [(2, 16, 2048), (2, 4096, 1024), (4, 1, 1024)])
def test_gru_plan_steps_where_weights_do_not_fit(D, B, H):
    """Where no block size keeps a block's w_hh rows (and the step's gi) in
    shared memory with one block an SM, the planner picks the
    one-launch-a-step route, which takes any shape; it never raises."""
    plan = gru_fwd_plan(D, B, H, H100_SMS, H100_SMEM)
    assert plan.route == "steps" and plan.units == 8 and plan.smem == 0
    assert plan.blocks == D * H // 8


def _gru_inputs(D, B, T, H, seed=0):
    rng = np.random.default_rng(seed)
    gi = (rng.standard_normal((D, B, T, 3 * H)) * 0.5).astype(np.float32)
    w_hh = rng.uniform(-1, 1, (D, H, 3 * H)).astype(np.float32) / np.sqrt(H)
    b_hh = (rng.standard_normal((D, 3 * H)) * 0.1).astype(np.float32)
    return gi, w_hh, b_hh


@pytest.mark.parametrize("B,T", [(1, 12), (3, 20)])
def test_gru_plain_matches_pallas_interpret(B, T):
    """Plain GRU recurrence == gru_fwd_pallas(interpret=True) at D=2, H=128:
    both round h and w_hh to bf16 and accumulate in f32; atol 1e-4."""
    D, H = 2, 128
    gi, w_hh, b_hh = _gru_inputs(D, B, T, H, seed=B)
    want = np.asarray(gru_fwd_pallas(jnp.asarray(gi), jnp.asarray(w_hh), jnp.asarray(b_hh),
                                     interpret=True))
    got = gru_fwd(_t(gi), _t(w_hh).to(torch.bfloat16), _t(b_hh)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    torch.testing.assert_close(torch.from_numpy(got),
                               gru_fwd_plain(_t(gi), _t(w_hh), _t(b_hh)), rtol=0, atol=0)


def test_gru_wrappers_take_plain_only_on_cpu():
    """gru_fwd runs the plain version on CPU tensors and launches nothing;
    gru_fwd_steps (one route of the kernel, timed on the card) has no plain
    path and refuses CPU tensors, as both refuse any other device."""
    gi, w_hh, b_hh = (_t(a) for a in _gru_inputs(2, 1, 5, 16))
    w_hh = w_hh.to(torch.bfloat16)
    before = (gru_fwd.launches, gru_fwd.step_launches, gru_fwd.time_steps)
    torch.testing.assert_close(gru_fwd(gi, w_hh, b_hh), gru_fwd_plain(gi, w_hh, b_hh),
                               rtol=0, atol=0)
    assert (gru_fwd.launches, gru_fwd.step_launches, gru_fwd.time_steps) == before
    with pytest.raises(ValueError):
        gru_fwd_steps(gi, w_hh, b_hh)
    for fn in (gru_fwd, gru_fwd_steps):
        with pytest.raises(ValueError):
            fn(gi.to("meta"), w_hh.to("meta"), b_hh.to("meta"))


def test_port_bigru_matches_jax_scan():
    """The port's BiGRU at its default ``gru_impl="scan"`` (f32 hidden
    matmul) against the JAX f32 scan BiGRU: f32 on both sides, sums over
    H = 128 terms in another order, so atol 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 33, 48)) * 0.5).astype(np.float32)
    jm = JaxBiGRU(hidden=128)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    p = v["params"]
    tm = BiGRU(48, 128, device="cpu")
    sd = {}
    for d_, t_ in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"weight_ih_l0{t_}"] = _t(np.asarray(p[f"{d_}_w_ih"]).T)
        sd[f"weight_hh_l0{t_}"] = _t(np.asarray(p[f"{d_}_w_hh"]).T)
        sd[f"bias_ih_l0{t_}"] = _t(p[f"{d_}_b_ih"])
        sd[f"bias_hh_l0{t_}"] = _t(p[f"{d_}_b_hh"])
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
