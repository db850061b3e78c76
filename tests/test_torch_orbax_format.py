"""The port's orbax reader (``wavthruvec_pytorch_tpu_torch/orbax_format``)
against orbax, tensorstore and the ``zstandard`` binding, on the CPU.

* ``read_tree`` returns what ``ocp.StandardCheckpointer().restore(path)``
  returns, bit for bit: on the committed fixtures of the JAX package
  (``tests/fixtures/jax_orbax``, written by ``tests/make_jax_orbax_fixtures.py``)
  and on a tree written here with every dtype the reader takes, 0-d arrays,
  Python scalars, empty containers, an array of 1.3 MB (several Huffman
  blocks, a value in a data file), an all-zero array (RLE blocks) and an
  array sharded over the suite's 8 CPU devices (a grid of 8 chunks).
* The OCDBT store's keys and values equal tensorstore's ``ocdbt`` kvstore's,
  and every array decoded here equals tensorstore's ``zarr`` driver reading
  the same chunks; tensorstore also writes stores with interior b-tree
  nodes and uncompressed nodes for the walk.
* The zstd decoder gives back what ``zstandard`` compressed, on frames
  with the features orbax does not use: checksums, content sizes, several
  and skippable frames, levels from -5 to 19.
* A flipped byte in a manifest, a node or a chunk's block header raises.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch
import zstandard

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch.orbax_format import ocdbt, zarr, zstd
from wavthruvec_pytorch_tpu_torch.orbax_format.tree import read_tree
from wavthruvec_pytorch_tpu_torch.orbax_format.zarr import ArrayPlan, ZarrError, read_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "jax_orbax")
FIXTURE_DIRS = ("checkpoint_1", "t2v_variables", "gen_variables")


def assert_same_tree(ref, got, path="tree"):
    """``got`` (the port's) equals ``ref`` (orbax's): the same containers,
    keys, scalar types, dtypes and shapes, and the same bits."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(ref) == sorted(got), path
        for k in ref:
            assert_same_tree(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(ref) == len(got), path
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same_tree(r, g, f"{path}/{i}")
    elif ref is None:
        assert got is None, path
    elif isinstance(ref, (int, float)):
        assert type(got) is type(ref) and got == ref, (path, ref, got)
    else:
        ref = np.asarray(ref)
        if ref.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == ref.shape, path
            np.testing.assert_array_equal(got.view(torch.uint16).numpy(), ref.view(np.uint16))
        else:
            assert isinstance(got, np.ndarray), (path, type(got))
            assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
            assert got.tobytes() == ref.tobytes(), path


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    rng = np.random.default_rng(0)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    tree = {
        "f4": rng.standard_normal((3, 5)).astype(np.float32),
        "f8": rng.standard_normal(7),
        "i4": np.arange(-5, 5, dtype=np.int32),
        "i8": np.arange(6, dtype=np.int64).reshape(2, 3),
        "b1": np.array([True, False, True]),
        "u1": np.arange(256, dtype=np.uint8),
        "bf16": jnp.asarray(rng.standard_normal((4, 9)), jnp.bfloat16),
        "step": jnp.asarray(3, jnp.int32),
        "count": np.int64(11),
        "python": [7, 0.25],
        "big": rng.standard_normal((512, 640)).astype(np.float32),
        "zeros": np.zeros(200_000, np.float32),
        "sharded": jax.device_put(jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6),
                                  NamedSharding(mesh, PartitionSpec("x"))),
        "nested": {"pair": (np.ones(2, np.float32), {"empty": {}}), "none": None, "list": []},
    }
    path = str(tmp_path_factory.mktemp("orbax") / "synthetic")
    saver = ocp.StandardCheckpointer()
    saver.save(path, tree)
    saver.wait_until_finished()
    return path, ocp.StandardCheckpointer().restore(path)


def test_synthetic_tree_equals_orbax_restore(synthetic):
    path, ref = synthetic
    stats = {}
    got = ckpt.restore_checkpoint(path, stats)
    assert_same_tree(ref, got)
    assert stats["bytes"] > 1_000_000 and stats["seconds"] > 0
    store = ocdbt.OcdbtStore(path)
    # the sharded array is a grid of 8 chunks, one a device
    assert [k for k in store.keys() if k.startswith(b"sharded/") and b".zarray" not in k] == \
        [f"sharded/{i}.0".encode() for i in range(8)]
    big = store.read(b"big/0.0")
    assert len(big) > 1024                       # past max_inline_value_bytes: a data file
    frame = zstd._Pass1().frames(big)[0]
    assert sum(b[0] == "lit" for b in frame.blocks) > 8     # many Huffman blocks
    zeros = zstd._Pass1().frames(store.read(b"zeros/0"))[0]
    assert len(zeros.blocks) >= 6


@pytest.mark.parametrize("group_bytes", [1, 300_000])
def test_read_arrays_in_groups(synthetic, group_bytes, monkeypatch):
    """The chunks decompressed a group at a time (``GROUP_BYTES`` of stored
    chunks a group; 1: an array a group) give the arrays of one group."""
    path, _ = synthetic
    store = ocdbt.OcdbtStore(path)
    names = sorted({k.decode().rsplit("/", 1)[0] for k in store.keys()
                    if k.endswith(b"/.zarray")})
    whole, grouped = {}, {}
    want = read_arrays(store, names, whole)
    monkeypatch.setattr(zarr, "GROUP_BYTES", group_bytes)
    got = read_arrays(store, names, grouped)
    assert whole == grouped and len(got) == len(want) == len(names) > 10
    bits = lambda a: a.view(torch.uint16).numpy() if isinstance(a, torch.Tensor) else a  # noqa: E731
    for name, a, b in zip(names, want, got):
        assert_same_tree(bits(a), bits(b), name)


@pytest.mark.parametrize("name", FIXTURE_DIRS)
def test_fixture_equals_orbax_restore(name):
    path = os.path.join(FIXTURES, name)
    assert_same_tree(ocp.StandardCheckpointer().restore(path), read_tree(path))


@pytest.mark.parametrize("name", FIXTURE_DIRS)
def test_store_and_chunks_equal_tensorstore(name):
    """Keys and values equal tensorstore's ``ocdbt`` kvstore; each array,
    its chunks decoded by the port's zstd, equals tensorstore's ``zarr``
    driver on the same store."""
    path = os.path.join(FIXTURES, name)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}"}).result()
    want_keys = [bytes(k) for k in kv.list().result()]
    store = ocdbt.OcdbtStore(path)
    assert store.keys() == sorted(want_keys)
    for key in want_keys:
        assert store.read(key) == bytes(kv.read(key).result().value), key
    tree = read_tree(path)
    names = sorted({k.split(b"/")[0].decode() for k in want_keys})
    n = 0
    for name_ in names:
        arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}",
                                                     "path": name_ + "/"}}).result().read().result()
        node = tree
        for part in name_.split("."):
            node = node[int(part)] if isinstance(node, list) else node[part]
        got = np.asarray(node) if not isinstance(node, torch.Tensor) else \
            node.view(torch.uint16).numpy()
        want = np.asarray(arr)
        if want.dtype.name == "bfloat16":
            want = want.view(np.uint16)
        assert np.asarray(got).tobytes() == want.tobytes(), name_
        n += 1
    assert n == len(names) > 10


def _frames():
    """{case: (frames, their content)}"""
    rng = np.random.default_rng(1)
    floats = rng.standard_normal(70_000).astype(np.float32).tobytes()
    text = b"".join(b"sentence %d of a repetitive corpus\n" % i for i in range(4000))
    noise = rng.bytes(300_000)
    c1, c3 = zstandard.ZstdCompressor(level=1), zstandard.ZstdCompressor(level=3)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    streamed = c3.compressobj()
    return {
        "checksum": (zstandard.ZstdCompressor(level=3, write_checksum=True).compress(floats),
                     floats),
        "content_size": (zstandard.ZstdCompressor(level=1, write_content_size=True)
                         .compress(text), text),
        "level19_text": (zstandard.ZstdCompressor(level=19).compress(text), text),
        "negative_level": (zstandard.ZstdCompressor(level=-5).compress(floats), floats),
        "random_raw_blocks": (c1.compress(noise), noise),
        "empty": (zstandard.ZstdCompressor(level=1, write_content_size=True).compress(b""), b""),
        "frames_and_skippable": (c3.compress(text) + skip + c3.compress(floats), text + floats),
        "streamed": (streamed.compress(text) + streamed.flush(), text),
    }


FRAMES = _frames()


@pytest.mark.parametrize("case", sorted(FRAMES))
def test_zstd_equals_zstandard(case):
    data, content = FRAMES[case]
    assert zstd.decompress(data) == content


def test_zstd_checksum_mismatch_raises():
    frame = bytearray(FRAMES["checksum"][0])
    frame[-1] ^= 0x40
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(frame))
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


def _copy(tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(os.path.join(FIXTURES, name), dst)
    return dst


def _flip(path, offset, bit=0x10):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ bit]))


@pytest.mark.parametrize("where", ["manifest", "node", "chunk"])
def test_flipped_byte_raises(tmp_path, synthetic, where):
    if where == "chunk":
        path = str(tmp_path / "synthetic")
        shutil.copytree(synthetic[0], path)
        store = ocdbt.OcdbtStore(path)
        loc = store._root
        node = store._node(loc)
        i = node.keys.index(b"big/0.0")
        rel, offset, _ = node.values[i]
        _flip(os.path.join(path, rel), offset + 8, 0x80)     # the first block's size
        with pytest.raises(zstd.ZstdError):
            read_tree(path)
        return
    path = _copy(tmp_path, "t2v_variables")
    if where == "manifest":
        _flip(os.path.join(path, "manifest.ocdbt"), 20)
    else:
        store = ocdbt.OcdbtStore(path)
        rel, offset, length, _ = store._root
        _flip(os.path.join(path, rel), offset + length // 2)
    with pytest.raises(ocdbt.OcdbtError, match="CRC-32C"):
        read_tree(path)


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 3}])
def test_interior_nodes_and_indirect_values(tmp_path, compression):
    """A store tensorstore writes with 200-byte nodes (a b-tree of several
    levels) and values past 8 bytes in data files, in one transaction and
    then a second one over some of the keys: the newest version reads."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"compression": compression, "max_decoded_node_bytes": 200,
                       "max_inline_value_bytes": 8}}
    kv = ts.KvStore.open(spec).result()
    want = {}
    for round_ in range(2):
        txn = ts.Transaction()
        for i in range(0, 60, round_ + 1):
            key = b"key%03d/%s" % (i, b"x" * (i % 5))
            want[key] = bytes([65 + (i + round_) % 26]) * (3 + i)
            kv.with_transaction(txn).write(key, want[key]).result()
        txn.commit_async().result()
    store = ocdbt.OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(want)
    assert all(store.read(k) == v for k, v in want.items())
    assert store.read(b"key000") is None and store.read(b"zzz") is None
    assert store._root[3] >= 2                     # the root is an interior node


def test_dtypes_and_unfinished_saves(tmp_path):
    meta = {"zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f2", "compressor": None,
            "fill_value": None, "order": "C", "filters": None}
    with pytest.raises(ZarrError, match="<f2"):
        ArrayPlan("half", meta)
    plan = ArrayPlan("missing", dict(meta, dtype="<i4", fill_value=7, shape=[5], chunks=[2]))
    np.testing.assert_array_equal(plan.assemble([None] * 3), np.full(5, 7, np.int32))
    tmp = tmp_path / "state_00000005.orbax-checkpoint-tmp-1792339109"
    shutil.copytree(os.path.join(FIXTURES, "gen_variables"), tmp)
    shutil.copytree(os.path.join(FIXTURES, "gen_variables"), tmp_path / "state_00000004")
    assert ckpt.scan_checkpoint(str(tmp_path), "state_").endswith("state_00000004")
    assert ckpt.newest_vec2wav(str(tmp_path))[1].endswith("state_00000004")
    with pytest.raises(ValueError, match="not finished"):
        read_tree(str(tmp))
    assert sorted(glob.glob(str(tmp_path / "*"))) and ckpt.orbax_layout(
        str(tmp_path / "state_00000004")) == "gen_variables"
