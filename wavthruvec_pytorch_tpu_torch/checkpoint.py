"""The torch reference's checkpoint files (JAX package: ``checkpoint.py``
``load_torch_state_dict`` :86-97, ``scan_checkpoint`` :60-81,
``save_reference_text2vec`` :538-556, ``save_reference_vec2wav`` :559-584).

* Text2Vec: ``checkpoint_{step}.pth.tar`` = {``model``, ``optimizer``,
  ``learning_rate``, ``epoch``} (text2vec/train.py:426-432);
* Vec2Wav: ``g_{step:08d}`` = {``generator``} and ``do_{step:08d}`` =
  {``mpd``, ``msd``, ``optim_g``, ``optim_d``, ``steps``, ``epoch``}
  (vec2wav/train.py:227-238); a run resumes from the newest pair
  (vec2wav/utils.py:53-58).

The state dicts' keys are the reference's (``weights.py`` emits the same
layout), so a file loads with ``load_state_dict(strict=True)``, here and in
the JAX package's importers (``import_text2vec``,
``import_vec2wav_generator``, ``import_vec2wav_mpd``,
``import_vec2wav_msd``).  The optimizer entries are the port's own
``state_dict()``s, the LAMB and AdamW moments included, so a resumed run
goes on from the same state.  Tensors are saved as CPU copies; each file is
written under a temporary name and then renamed, so a save cut short leaves
nothing that ``scan_checkpoint`` takes.

A directory is an orbax checkpoint of the JAX package, which cannot be read
without JAX: the JAX package's ``cli export-torch`` writes the reference
files from it, and those load here.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch

# a checkpoint's step ends its name, before the Text2Vec files' suffix
_STEP = re.compile(r"(\d+)(?:\.pth\.tar)?$")


def load_torch_state_dict(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The state dict in the reference file ``path`` (``key`` selects a
    sub-dict such as ``model`` or ``generator``), as CPU tensors."""
    obj = _load(path)
    if key is not None:
        obj = obj[key]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def _load(path: str) -> Any:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an orbax checkpoint of the JAX package, which the port "
            "cannot read without JAX.  Write the torch reference's files from it with the JAX "
            "package's `python -m wavthruvec_pytorch_tpu.cli export-torch --stage t2v|v2w "
            "--checkpoint <dir>` (checkpoint_{step}.pth.tar, g_XXXXXXXX) and pass those.")
    return torch.load(path, map_location="cpu", weights_only=False)


def checkpoint_step(path: str) -> int:
    """The step in a checkpoint's name (``checkpoint_12.pth.tar`` -> 12,
    ``g_00000012`` -> 12), or -1 for a name without one, such as a
    temporary file of a save in progress."""
    m = _STEP.search(os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else -1


def scan_checkpoint(cp_dir: str, prefix: str) -> Optional[str]:
    """The checkpoint under ``cp_dir`` named ``prefix`` + step with the
    highest step (by number: ``checkpoint_1200`` is not zero-padded), or
    None."""
    paths = [p for p in glob.glob(os.path.join(cp_dir, glob.escape(prefix) + "*"))
             if checkpoint_step(p) >= 0]
    return max(paths, key=checkpoint_step) if paths else None


def _cpu(obj: Any) -> Any:
    """A copy of ``obj`` with every tensor moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _save(obj: Dict[str, Any], path: str) -> None:
    """``torch.save`` of CPU copies to a temporary name, then renamed."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_cpu(obj), tmp)
    os.replace(tmp, path)


# --- Text2Vec ----------------------------------------------------------------

def text2vec_path(cp_dir: str, step: int) -> str:
    return os.path.join(cp_dir, f"checkpoint_{step}.pth.tar")


def save_text2vec(path: str, trainer, epoch: int) -> None:
    """A ``Text2VecTrainer`` as ``checkpoint_{step}.pth.tar``: the model
    (BatchNorm statistics included), the LAMB state dict, its lr and the
    epoch."""
    state = trainer.state_dict()
    _save({"model": state["model"], "optimizer": state["optimizer"],
           "learning_rate": trainer.learning_rate, "epoch": epoch}, path)


def load_text2vec(path: str, trainer) -> int:
    """Load ``checkpoint_{step}.pth.tar`` into a ``Text2VecTrainer`` built
    with the same config; its step count becomes the step in the file's
    name, as the reference's ``--restore_step`` says.  Returns the file's
    epoch."""
    step = checkpoint_step(path)
    if step < 0:
        raise ValueError(f"{path}: no step in the name")
    obj = _load(path)
    trainer.load_state_dict({"model": obj["model"], "optimizer": obj["optimizer"],
                             "step_count": step})
    return int(obj["epoch"])


# --- Vec2Wav -----------------------------------------------------------------

def save_vec2wav(cp_dir: str, steps: int, trainer, epoch: int) -> None:
    """A ``GANTrainer`` after the step numbered ``steps`` (0-based, as the
    reference counts) as ``g_{steps:08d}`` and ``do_{steps:08d}``."""
    state = trainer.state_dict()
    _save({"generator": state["generator"]}, os.path.join(cp_dir, f"g_{steps:08d}"))
    _save({"mpd": state["mpd"], "msd": state["msd"], "optim_g": state["optim_g"],
           "optim_d": state["optim_d"], "steps": steps, "epoch": epoch},
          os.path.join(cp_dir, f"do_{steps:08d}"))


def latest_vec2wav(cp_dir: str):
    """The newest ``(g_, do_)`` pair of one step under ``cp_dir``, or None."""
    do = scan_checkpoint(cp_dir, "do_")
    if do is None:
        return None
    g = os.path.join(cp_dir, f"g_{checkpoint_step(do):08d}")
    if not os.path.isfile(g):
        raise FileNotFoundError(f"{do} has no generator file {g}")
    return g, do


def load_vec2wav(g_path: str, do_path: str, trainer) -> Dict[str, int]:
    """Load a ``g_``/``do_`` pair into a ``GANTrainer`` built with the same
    config.  Returns ``{"steps": the next step's number, "epoch"}``, as the
    reference resumes (vec2wav/train.py:74-89)."""
    do = _load(do_path)
    steps = int(do["steps"]) + 1
    trainer.load_state_dict({"generator": _load(g_path)["generator"], "mpd": do["mpd"],
                             "msd": do["msd"], "optim_g": do["optim_g"],
                             "optim_d": do["optim_d"], "step_count": steps})
    return {"steps": steps, "epoch": int(do["epoch"])}
