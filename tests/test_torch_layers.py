"""Each layer of the PyTorch port's models/layers.py against its JAX
counterpart on the CPU: same numpy inputs, JAX weights carried over with the
port's weights.py transposes, f32, atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu.models import layers as jl
from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.models import layers as tl

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _load(module, jvars, spec_rows):
    """Export JAX variables (nested under "m") with the port's own spec rows
    and strict-load them into ``module``."""
    wrapped = {col: {"m": _np_tree(sub)} for col, sub in jvars.items()}
    sd = weights._export(wrapped, spec_rows)
    sd = {k[2:] if k.startswith("m.") else k: torch.tensor(v) for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module


def _run(jmod, jvars, tmod, x):
    want = np.asarray(jmod.apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.tensor(x)).numpy()
    return got, want


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("gain", ["linear", "relu"])
def test_linear(gain):
    x = _x((2, 5, 12))
    jm = jl.Linear(7, w_init_gain=gain)
    jv = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _load(tl.Linear(12, 7, w_init_gain=gain, device="cpu"), jv,
               [("lin", "m.linear_layer", "m/Dense_0")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


def test_torch_linear():
    x = _x((3, 12))
    jm = jl.TorchLinear(9)
    jv = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tm = _load(tl.TorchLinear(12, 9, device="cpu"), jv, [("lin", "m", "m/Dense_0")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


@pytest.mark.parametrize("k,pad,dil,bias", [(1, 0, 1, True), (3, 1, 1, False),
                                            (5, 2, 1, True), (3, 4, 4, True), (4, 2, 1, False)])
def test_conv1d(k, pad, dil, bias):
    x = _x((2, 17, 6))
    jm = jl.Conv1d(10, kernel_size=k, padding=pad, dilation=dil, use_bias=bias)
    jv = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    tm = _load(tl.Conv1d(6, 10, k, padding=pad, dilation=dil, bias=bias, device="cpu"), jv,
               [("conv", "m", "m/Conv_0")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


def test_layer_norm():
    x = _x((2, 9, 16)) * 3 + 1
    jm = jl.LayerNorm()
    jv = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    rng = np.random.default_rng(3)
    jv = {"params": {"LayerNorm_0": {"scale": rng.standard_normal(16).astype(np.float32),
                                     "bias": rng.standard_normal(16).astype(np.float32)}}}
    tm = _load(tl.LayerNorm(16, device="cpu"), jv, [("ln", "m", "m/LayerNorm_0")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


@pytest.mark.parametrize("shape,affine", [((2, 9, 8), True), ((4, 8), True), ((2, 9, 8), False)])
def test_batch_norm_eval(shape, affine):
    x = _x(shape)
    jm = jl.BatchNorm(use_running_average=True, use_scale=affine, use_bias=affine)
    jv = _np_tree(jm.init(jax.random.PRNGKey(4), jnp.asarray(x)))
    rng = np.random.default_rng(4)
    jv["batch_stats"]["BatchNorm_0"] = {
        "mean": rng.standard_normal(8).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    if affine:
        jv["params"]["BatchNorm_0"] = {"scale": rng.standard_normal(8).astype(np.float32),
                                       "bias": rng.standard_normal(8).astype(np.float32)}
    tm = _load(tl.BatchNorm(8, affine=affine, device="cpu").eval(), jv,
               [("bn" if affine else "bn_na", "m", "m")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


def test_highway():
    x = _x((2, 7, 12))
    jm = jl.Highway(12)
    jv = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tm = _load(tl.Highway(12, 12, device="cpu"), jv,
               [("lin", "m.H", "m/Dense_0"), ("lin", "m.T", "m/Dense_1")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


@pytest.mark.parametrize("k,dil,w_std", [(7, 1, None), (3, 3, 0.01), (11, 1, 0.01)])
def test_wn_conv1d(k, dil, w_std):
    x = _x((2, 20, 8))
    pad = (k * dil - dil) // 2
    jm = jl.WNConv1d(6, kernel_size=k, padding=pad, dilation=dil, w_std=w_std)
    jv = _np_tree(jm.init(jax.random.PRNGKey(6), jnp.asarray(x)))
    # move g off ||v|| so the normalisation is exercised
    jv["params"]["g"] = jv["params"]["g"] * np.float32(1.7)
    tm = _load(tl.WNConv1d(8, 6, k, padding=pad, dilation=dil, w_std=w_std, device="cpu"),
               jv, [("wn", "m", "m")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


@pytest.mark.parametrize("k,u", [(11, 5), (8, 4), (4, 2)])
def test_wn_conv_transpose1d(k, u):
    x = _x((2, 9, 8))
    jm = jl.WNConvTranspose1d(6, kernel_size=k, stride=u, padding=(k - u) // 2)
    jv = _np_tree(jm.init(jax.random.PRNGKey(7), jnp.asarray(x)))
    jv["params"]["g"] = jv["params"]["g"] * np.float32(0.6)
    tm = _load(tl.WNConvTranspose1d(8, 6, k, u, padding=(k - u) // 2, device="cpu"), jv,
               [("wnT", "m", "m")])
    got, want = _run(jm, jv, tm, x)
    assert got.shape == (2, (9 - 1) * u - 2 * ((k - u) // 2) + k, 6)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_spectral_norm_dense_eval():
    x = _x((3, 10))
    jm = jl.SpectralNormDense(12, update_stats=False)
    jv = jm.init(jax.random.PRNGKey(8), jnp.asarray(x))
    tm = _load(tl.SpectralNormDense(10, 12, device="cpu").eval(), jv, [("snlin", "m", "m")])
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=ATOL)


def test_bigru_matches_jax_pallas_impl():
    """The port's BiGRU against JAX BiGRU(impl="pallas") (interpret mode on
    the CPU), the port's BiGRU built with the same impl: the same bf16
    rounding on both sides, so atol 1e-4."""
    x = _x((2, 19, 24)) * 0.5
    jm = jl.BiGRU(hidden=128, impl="pallas")
    jv = jm.init(jax.random.PRNGKey(9), jnp.asarray(x))
    rows = []
    for d_, t_ in (("fwd", ""), ("bwd", "_reverse")):
        rows += [("linw", f"m.weight_ih_l0{t_}", f"m/{d_}_w_ih"),
                 ("linw", f"m.weight_hh_l0{t_}", f"m/{d_}_w_hh"),
                 ("raw", f"m.bias_ih_l0{t_}", f"m/{d_}_b_ih"),
                 ("raw", f"m.bias_hh_l0{t_}", f"m/{d_}_b_hh")]
    tm = _load(tl.BiGRU(24, 128, gru_impl="pallas", device="cpu"), jv, rows)
    np.testing.assert_allclose(*_run(jm, jv, tm, x), atol=1e-4)
