"""Reading the torch reference's checkpoint files (JAX package:
``checkpoint.py`` ``load_torch_state_dict``, :86-97).

A file is the reference's pickle: ``checkpoint_{step}.pth.tar`` holds the
Text2Vec state dict under ``model``, ``g_XXXXXXXX`` the Generator's under
``generator``.  Its keys are already the port's (``weights.py`` emits the
same layout), so the dict loads with ``load_state_dict(strict=True)``.

A directory is an orbax checkpoint of the JAX package, which cannot be read
without JAX: the JAX package's ``cli export-torch`` writes the reference
files from it, and those load here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The state dict in the reference file ``path`` (``key`` selects a
    sub-dict such as ``model`` or ``generator``), as CPU tensors."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an orbax checkpoint of the JAX package, which the port "
            "cannot read without JAX.  Write the torch reference's files from it with the JAX "
            "package's `python -m wavthruvec_pytorch_tpu.cli export-torch --stage t2v|v2w "
            "--checkpoint <dir>` (checkpoint_{step}.pth.tar, g_XXXXXXXX) and pass those.")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        obj = obj[key]
    return {k: torch.as_tensor(v) for k, v in obj.items()}
