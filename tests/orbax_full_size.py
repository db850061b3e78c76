"""Full-size orbax training states of the JAX package, and the port's reader
timed on them against orbax's own restore (host CPU times, one core's
worth of Python for the port's reader):

    JAX_PLATFORMS=cpu python tests/orbax_full_size.py OUT_DIR [PAIRS]

writes ``OUT_DIR/checkpoint_1`` (a ``T2VTrainState`` at
``data/demo/text2vec.json``) and ``OUT_DIR/state_00000001`` (a
``GANTrainState`` at ``data/demo/vec2wav.json``) with the JAX package's
``save_checkpoint``, reads each with ``ocp.StandardCheckpointer().restore``
and with the port's ``checkpoint.restore_checkpoint``, holds the two trees
bit-equal, and prints one JSON line a state: its stored bytes, both
readers' seconds and the port's MB/s of stored bytes, and the port's
reader run again in a process of its own, with that process's peak
resident memory beside the tree's own bytes; then ``PAIRS`` alternating
pairs of that lone read with the whole checkpoint one decompression group
and with the reader's groups (``zarr.GROUP_BYTES``).  It imports JAX; it
is not collected by pytest (``tests/test_torch_orbax_full.py`` runs it as a
``slow`` test).

The states have ``init_state``'s structure, shapes and dtypes
(``jax.eval_shape``, without running the full-size init) and, at every
leaf, seeded random values as a state some steps into training holds:
weights N(0, 0.05), first moments N(0, 1e-3), second moments |N(0, 1e-6)|,
counts and steps 1, the hyperparameters the optimizer's own.
"""

import json
import os
import subprocess
import sys
import time
from typing import Optional

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wavthruvec_pytorch_tpu import checkpoint as jckpt  # noqa: E402
from wavthruvec_pytorch_tpu.config import Text2VecConfig, Vec2WavConfig, load_config  # noqa: E402
from wavthruvec_pytorch_tpu.train import text2vec_train as jt2v  # noqa: E402
from wavthruvec_pytorch_tpu.train import vec2wav_train as jv2w  # noqa: E402


def _fill(shapes, hyper, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k)))) for k in path]
        if "hyperparams" in names:
            return np.asarray(hyper[names[-1]], leaf.dtype)
        if np.issubdtype(leaf.dtype, np.integer):
            return np.ones(leaf.shape, leaf.dtype)
        if "nu" in names:
            v = np.abs(rng.standard_normal(leaf.shape, np.float32)) * 1e-6
        elif "mu" in names:
            v = rng.standard_normal(leaf.shape, np.float32) * 1e-3
        else:
            v = rng.standard_normal(leaf.shape, np.float32) * 0.05
        return v.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _hyperparams(tx) -> dict:
    """The values ``inject_hyperparams`` holds for the optimizer ``tx``."""
    return {k: np.asarray(v) for k, v in tx.init({"x": jnp.zeros(1)}).hyperparams.items()}


def text2vec_shapes(cfg):
    """A ``T2VTrainState``'s leaves as ``jax.ShapeDtypeStruct``s, and the
    values of its optimizer's hyperparameters."""
    B, N, T = 1, 8, 16
    batch = {"text": jnp.ones((B, N), jnp.int32), "src_pos": jnp.arange(1, N + 1)[None],
             "feat_target": jnp.zeros((B, T, cfg.n_feat_dim)),
             "input_lengths": jnp.array([N]), "output_lengths": jnp.array([T]),
             "feat_pos": jnp.arange(1, T + 1)[None], "attn_prior": jnp.ones((B, T, N))}
    shapes = jax.eval_shape(lambda k: jt2v.init_state(cfg, k, batch)[1], jax.random.PRNGKey(0))
    return shapes, _hyperparams(jt2v.make_optimizer(cfg))


def text2vec_state(cfg):
    return _fill(*text2vec_shapes(cfg), 0)


def vec2wav_state(cfg):
    batch = {"wv_feat": jnp.zeros((1, 8, cfg.n_feat_dim)), "spk_emb": jnp.zeros((1, cfg.spk_dim))}
    shapes = jax.eval_shape(lambda k: jv2w.init_state(cfg, k, batch)[1], jax.random.PRNGKey(0))
    return _fill(shapes, _hyperparams(jv2w.make_optimizers(cfg)[0]), 1)


def stored_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def assert_same(ref, got, where="tree"):
    import torch

    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(ref) == sorted(got), where
        for k in ref:
            assert_same(ref[k], got[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(ref), where
        for i, (r, g) in enumerate(zip(ref, got)):
            assert_same(r, g, f"{where}/{i}")
    elif ref is None or isinstance(ref, (int, float)):
        assert got == ref and type(got) is type(ref), where
    else:
        ref = np.asarray(ref)
        if isinstance(got, torch.Tensor):
            got = got.view(torch.uint16).numpy()
            ref = ref.view(np.uint16)
        assert got.dtype == ref.dtype and got.shape == ref.shape, where
        assert got.tobytes() == ref.tobytes(), where


_ALONE = """
import json, sys
from wavthruvec_pytorch_tpu_torch.checkpoint import restore_checkpoint
from wavthruvec_pytorch_tpu_torch.orbax_format import zarr


def hwm_kib():
    with open("/proc/self/status") as f:
        return int(next(line for line in f if line.startswith("VmHWM:")).split()[1])


if len(sys.argv) > 2:
    zarr.GROUP_BYTES = int(sys.argv[2])
base = hwm_kib()
stats = {}
tree = restore_checkpoint(sys.argv[1], stats)
print(json.dumps({"seconds": stats["seconds"], "import_kib": base, "peak_kib": hwm_kib()}))
"""


def port_read_alone(path: str, group_bytes: Optional[int] = None) -> dict:
    """The port's reader on ``path`` in a process of its own, which imports
    nothing else (``group_bytes``: the reader's ``zarr.GROUP_BYTES``, its
    default where None): its seconds, and the process's peak resident
    memory after its imports and after the read (``VmHWM``, KiB)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    args = [sys.executable, "-c", _ALONE, path] + ([str(group_bytes)] if group_bytes else [])
    out = subprocess.run(args, env=env, cwd=REPO, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def measure(path: str) -> dict:
    """Both readers on ``path``, the trees held bit-equal, and the port's
    reader again alone (``port_read_alone``) for its peak memory."""
    import orbax.checkpoint as ocp

    from wavthruvec_pytorch_tpu_torch.checkpoint import restore_checkpoint

    t0 = time.perf_counter()
    ref = ocp.StandardCheckpointer().restore(path)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    orbax_s = time.perf_counter() - t0
    stats = {}
    got = restore_checkpoint(path, stats)
    assert_same(ref, got)
    total = stored_bytes(path)
    tree_bytes = sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(ref))
    del ref, got
    alone = port_read_alone(path)
    return {"path": os.path.basename(path), "stored_bytes": total,
            "chunk_bytes": stats["bytes"], "tree_bytes": tree_bytes,
            "port_s": stats["seconds"], "orbax_s": orbax_s,
            "port_MBps": total / stats["seconds"] / 1e6,
            "orbax_MBps": total / orbax_s / 1e6,
            "port_alone_s": alone["seconds"],
            "port_alone_MBps": total / alone["seconds"] / 1e6,
            "port_alone_import_MiB": alone["import_kib"] / 1024,
            "port_alone_peak_MiB": alone["peak_kib"] / 1024}


def write_states(out: str) -> list:
    t2v_cfg = load_config(Text2VecConfig, os.path.join(REPO, "data", "demo", "text2vec.json"))
    v2w_cfg = load_config(Vec2WavConfig, os.path.join(REPO, "data", "demo", "vec2wav.json"))
    paths = [os.path.join(out, "checkpoint_1"), os.path.join(out, "state_00000001")]
    jckpt.save_checkpoint(paths[0], text2vec_state(t2v_cfg))
    jckpt.save_checkpoint(paths[1], vec2wav_state(v2w_cfg))
    return paths


def group_pairs(path: str, pairs: int) -> list:
    """``pairs`` alternating pairs of the port's reader alone on ``path``:
    the whole checkpoint one decompression group (the reader before groups)
    and groups of ``zarr.GROUP_BYTES``."""
    rows = []
    for i in range(2 * pairs):
        whole = (i % 2 == 0) == (i // 2 % 2 == 0)          # AB BA AB ...
        r = port_read_alone(path, 1 << 62 if whole else None)
        rows.append({"path": os.path.basename(path), "groups": "one" if whole else "default",
                     "s": r["seconds"], "MBps": stored_bytes(path) / r["seconds"] / 1e6,
                     "peak_MiB": r["peak_kib"] / 1024, "import_MiB": r["import_kib"] / 1024})
    return rows


def main(argv) -> int:
    """``OUT_DIR [PAIRS]``: write the states, measure both readers on each,
    then ``PAIRS`` (default 0) pairs of ``group_pairs`` on each."""
    out = argv[1] if len(argv) > 1 else "./orbax_full"
    pairs = int(argv[2]) if len(argv) > 2 else 0
    os.makedirs(out, exist_ok=True)
    paths = write_states(out)
    for path in paths:
        print(json.dumps(measure(path)), flush=True)
    for path in paths:
        for row in group_pairs(path, pairs):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
