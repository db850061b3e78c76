"""The port's native ``.npy`` reader (``data/native_io.py``, its own copy of
the C++ source in ``csrc/npy_loader.cc``) against ``np.load`` and the JAX
package's reader, the cases of ``tests/test_native_io.py``.

Tolerance: none.  Every read equals ``np.load(...).astype(np.float32)``
exactly (a float64 is rounded to float32 once on both sides, the integers
are exact in float32), and equals the JAX package's native read.
"""

import dataclasses
import os

import numpy as np
import pytest

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests.test_torch_train import JCFG
from wavthruvec_pytorch_tpu.data import native_io as jax_native_io
from wavthruvec_pytorch_tpu.data.dataset import load_buffer as jax_load_buffer
from wavthruvec_pytorch_tpu.text import TextFrontend as JTextFrontend
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig
from wavthruvec_pytorch_tpu_torch.data import native_io
from wavthruvec_pytorch_tpu_torch.data.dataset import load_buffer
from wavthruvec_pytorch_tpu_torch.ops.kernel_build import BUILD_DIR
from wavthruvec_pytorch_tpu_torch.text import TextFrontend


def test_library_built_into_the_port_build_dir():
    """g++ builds the port's own source into the port's ``build/``, named
    by the source's hash; reads take it, not ``np.load``."""
    lib = native_io.get_lib()
    assert lib is not None and native_io.reader() == "native"
    path = native_io.library_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.isfile(path)
    assert os.path.basename(path).startswith("libwtv_io-")
    assert native_io.SRC.endswith(os.path.join("wavthruvec_pytorch_tpu_torch", "csrc",
                                               "npy_loader.cc"))


@pytest.mark.parametrize("dtype,shape", [(np.float32, (1, 37, 64)), (np.float64, (5, 3)),
                                         (np.int16, (7,)), (np.int64, (2, 2, 2, 2))])
def test_read_npy_dtypes(tmp_path, dtype, shape):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal(shape) if np.dtype(dtype).kind == "f"
           else rng.integers(-100, 100, shape)).astype(dtype)
    path = str(tmp_path / "a.npy")
    np.save(path, arr)
    with native_io.Prefetcher([path]) as pf:
        got = pf.get(0)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, np.load(path).astype(np.float32))
    np.testing.assert_array_equal(got, jax_native_io.read_npy(path))


def test_prefetcher_falls_back_where_the_native_read_fails(tmp_path, capsys):
    """A file the native reader does not parse (float16, Fortran order) is
    read by ``np.load`` instead, and the fallback is printed; its
    neighbours stay native reads, in order."""
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((1, 9, 4)).astype(np.float32),
              rng.standard_normal((6, 5)).astype(np.float16),
              np.asfortranarray(rng.standard_normal((7, 3)).astype(np.float32)),
              rng.standard_normal((2, 8)).astype(np.float32)]
    paths = [str(tmp_path / f"f{i}.npy") for i in range(len(arrays))]
    for p, a in zip(paths, arrays):
        np.save(p, a)
    with native_io.Prefetcher(paths) as pf:
        for i, a in enumerate(arrays):
            got = pf.get(i)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, a.astype(np.float32))
    out = capsys.readouterr().out
    assert out.count("npy reader: np.load for") == 2
    assert paths[1] in out and paths[2] in out


def test_prefetcher_in_order(tmp_path):
    """More files than ``WINDOW`` ahead of ``get``, read on the threads,
    come back in order."""
    rng = np.random.default_rng(1)
    paths, arrays = [], []
    for i in range(native_io.WINDOW + 32):
        a = rng.standard_normal((1, int(rng.integers(5, 50)), 16)).astype(np.float32)
        paths.append(str(tmp_path / f"f{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
    with native_io.Prefetcher(paths) as pf:
        assert len(pf) == len(paths)
        for i, a in enumerate(arrays):
            np.testing.assert_array_equal(pf.get(i), a)


def test_prefetcher_feeds_buffer_loader(tmp_path):
    """``load_buffer`` reads through the prefetcher: the features
    ``np.load`` reads, and the JAX package's ``load_buffer``'s buffer."""
    cfg = Text2VecConfig(**{k: getattr(JCFG, k) for k in ("n_feat_dim", "vocab_size")},
                         betabinom_cache_path=str(tmp_path / "prior"),
                         feat_ground_truth=str(tmp_path))
    rng = np.random.default_rng(2)
    lines = []
    for i in range(4):
        np.save(tmp_path / f"u{i}.npy",
                rng.standard_normal((1, 20 + i, cfg.n_feat_dim)).astype(np.float32))
        lines.append(f"u{i}.npy|abc|spk")
    flist = tmp_path / "list.txt"
    flist.write_text("\n".join(lines) + "\n")
    buf = load_buffer([str(flist)], cfg, TextFrontend("PE abc"))
    jcfg = dataclasses.replace(JCFG, betabinom_cache_path=cfg.betabinom_cache_path,
                               feat_ground_truth=str(tmp_path))
    jbuf = jax_load_buffer([str(flist)], jcfg, JTextFrontend("PE abc"))
    assert len(buf) == len(jbuf) == 4
    for i, (got, jwant) in enumerate(zip(buf, jbuf)):
        np.testing.assert_array_equal(got["feat_gt_target"],
                                      np.load(tmp_path / f"u{i}.npy")[0])
        for k in ("feat_gt_target", "text_enc", "attn_prior"):
            np.testing.assert_array_equal(got[k], jwant[k], err_msg=k)
