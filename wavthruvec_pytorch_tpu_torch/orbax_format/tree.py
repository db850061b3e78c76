"""An orbax ``StandardCheckpointer`` directory as a nested tree, the tree
``ocp.StandardCheckpointer().restore(path)`` returns without a target:

* ``_METADATA`` lists every leaf by its key path, each key with its type
  (``key_type`` 2: a dict key or a NamedTuple's field, so both come back as
  dicts; 1: a sequence index, so tuples and lists come back as lists), and
  its value type;
* a ``jax.Array`` or ``np.ndarray`` leaf is the zarr array named by its
  keys joined with "." (``params.a``), read from the OCDBT store; a
  ``scalar`` leaf is that array's one value as a Python int or float;
  ``Dict``, ``List`` and ``None`` leaves are an empty dict, an empty list
  and None.

Arrays come back as numpy arrays, bfloat16 ones as ``torch.bfloat16``
tensors (``zarr.py``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from wavthruvec_pytorch_tpu_torch.orbax_format.ocdbt import OcdbtStore
from wavthruvec_pytorch_tpu_torch.orbax_format.zarr import read_arrays

# a directory orbax is still writing (or left when a save was cut short)
TMP_MARK = ".orbax-checkpoint-tmp"
_EMPTY = {"Dict": dict, "List": list, "None": lambda: None}
_ARRAYS = ("jax.Array", "np.ndarray", "scalar")


def _metadata(path: str) -> Dict[str, Any]:
    if TMP_MARK in os.path.basename(os.path.normpath(path)):
        raise ValueError(f"{path} is an orbax save that has not finished")
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path} is not an orbax checkpoint: it has no _METADATA")
    with open(meta_path, encoding="utf-8") as f:
        return json.load(f)["tree_metadata"]


def top_level_keys(path: str) -> List[str]:
    """The checkpoint's top-level keys, from its metadata alone."""
    return sorted({entry["key_metadata"][0]["key"] for entry in _metadata(path).values()})


def read_tree(path: str, stats: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The checkpoint at ``path`` as a nested tree of dicts, lists, Python
    scalars and arrays.  ``stats`` gets the arrays' stored bytes
    (``"bytes"``) and the seconds the read took (``"seconds"``)."""
    t0 = time.perf_counter()
    entries = list(_metadata(path).values())
    leaves: List[tuple] = []
    names: List[str] = []
    for entry in entries:
        keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        if vtype in _EMPTY:
            leaves.append((keys, _EMPTY[vtype]()))
        elif vtype in _ARRAYS:
            leaves.append((keys, (len(names), vtype == "scalar")))
            names.append(".".join(k for k, _ in keys))
        else:
            raise ValueError(f"{path}: leaf {'/'.join(k for k, _ in keys)} has value type "
                             f"{vtype!r}, which is not taken")
    st: Dict[str, float] = {}
    arrays = read_arrays(OcdbtStore(path), names, st) if names else []
    root: Dict[str, Any] = {}
    for keys, value in leaves:
        if isinstance(value, tuple):
            i, scalar = value
            value = arrays[i].item() if scalar else arrays[i]
        _insert(root, keys, value)
    if stats is not None:
        stats["bytes"] = stats.get("bytes", 0) + st.get("bytes", 0)
        stats["seconds"] = stats.get("seconds", 0.0) + time.perf_counter() - t0
    return _lists(root)


def _insert(root: Dict, keys, value) -> None:
    node = root
    for key, ktype in keys[:-1]:
        node = node.setdefault(int(key) if ktype == 1 else key, {})
    last, ktype = keys[-1]
    node[int(last) if ktype == 1 else last] = value


def _lists(node):
    """Sequence nodes (int keys 0..n-1) become lists."""
    if not isinstance(node, dict) or not node:
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"sequence with indices {sorted(out)}")
        return [out[i] for i in range(len(out))]
    return out
