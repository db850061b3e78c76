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

A directory is an orbax checkpoint of the JAX package, read here without
JAX by ``orbax_format`` (``restore_checkpoint``, the counterpart of the JAX
``restore_checkpoint(path, target=None)``).  Its top-level keys say what it
holds (``ORBAX_LAYOUTS``): variables (what the JAX ``recalibrate-bn``
writes), which serving and evaluation take as the JAX package does, or a
training state (``T2VTrainState``, ``GANTrainState``), which the training
loops resume from, moments included (``load_text2vec``,
``load_jax_vec2wav``), and ``export-torch`` converts.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Optional

import torch

from wavthruvec_pytorch_tpu_torch import weights
from wavthruvec_pytorch_tpu_torch.orbax_format import tree as orbax_tree

# a checkpoint's step ends its name, before the Text2Vec files' suffix
_STEP = re.compile(r"(\d+)(?:\.pth\.tar)?$")

# the JAX package's orbax checkpoints, by their top-level keys
ORBAX_LAYOUTS = {
    # recalibrate-bn's outputs (JAX cli.py:179, :249)
    ("batch_stats", "params"): "t2v_variables",
    ("batch_stats", "params", "spectral"): "gen_variables",
    # the loops' checkpoint_{it} and state_XXXXXXXX (train/text2vec_train.py:49-53,
    # train/vec2wav_train.py:44-52)
    ("batch_stats", "opt_state", "params", "step"): "t2v_state",
    ("disc_params", "gen_batch_stats", "gen_params", "gen_spectral", "msd_spectral",
     "opt_d_state", "opt_g_state", "step"): "gan_state",
}
_VARIABLES = {"model": ("t2v_variables", weights.text2vec_state_dict),
              "generator": ("gen_variables", weights.generator_state_dict)}


def restore_checkpoint(path: str, stats: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """The orbax checkpoint at ``path`` as the tree the JAX package's
    ``restore_checkpoint(path, target=None)`` returns (dicts, lists, Python
    scalars and numpy arrays; bfloat16 arrays as torch tensors), read
    without JAX.  ``stats`` gets the bytes read and the seconds taken."""
    return orbax_tree.read_tree(path, stats)


def orbax_layout(path: str) -> str:
    """Which of ``ORBAX_LAYOUTS`` the orbax checkpoint at ``path`` is; any
    other raises, naming the top-level keys it found."""
    keys = tuple(orbax_tree.top_level_keys(path))
    if keys not in ORBAX_LAYOUTS:
        raise ValueError(f"{path}: an orbax checkpoint with top-level keys {list(keys)}, which "
                         "no command takes (Text2Vec or Generator variables, a T2VTrainState "
                         "or a GANTrainState)")
    return ORBAX_LAYOUTS[keys]


def load_torch_state_dict(path: str, key: Optional[str] = None,
                          cfg: Any = None) -> Dict[str, torch.Tensor]:
    """The state dict in the reference file ``path`` (``key`` selects a
    sub-dict such as ``model`` or ``generator``), as CPU tensors.  A
    directory is the JAX package's orbax variables of that model (``key``
    ``model``: Text2Vec's {params, batch_stats}; ``generator``: the
    Generator's {params, batch_stats, spectral}), mapped to the port's keys
    with ``cfg``; a training state raises there, as the JAX package's
    restore into variables does."""
    if os.path.isdir(path):
        return variables_state_dict(path, key, cfg)
    obj = _load(path)
    if key is not None:
        obj = obj[key]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def variables_state_dict(path: str, key: str, cfg: Any) -> Dict[str, torch.Tensor]:
    """The orbax variables directory ``path`` as the port's state dict of
    the model ``key`` names (``_VARIABLES``)."""
    want, to_state_dict = _VARIABLES[key]
    layout = orbax_layout(path)
    if layout in ("t2v_state", "gan_state"):
        raise ValueError(
            f"{path} is a training state of the JAX package ({layout}); serving and eval take "
            "variables, as the JAX package's restore_checkpoint(path, variables) does.  Convert "
            "it with `python -m wavthruvec_pytorch_tpu_torch.cli export-torch --stage "
            f"{'t2v' if layout == 't2v_state' else 'v2w'} --checkpoint {path}`, or resume "
            "training from it (train-text2vec --restore_step N; train-vec2wav resumes from the "
            "newest state_XXXXXXXX by itself)")
    if layout != want:
        raise ValueError(f"{path} holds {layout}, where {key!r} takes {want}")
    return to_state_dict(restore_checkpoint(path), cfg)


def _load(path: str) -> Any:
    """A reference file's dict, or an orbax checkpoint's tree (whose layout
    must be one of ``ORBAX_LAYOUTS``)."""
    if os.path.isdir(path):
        orbax_layout(path)
        return restore_checkpoint(path)
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
             if checkpoint_step(p) >= 0 and orbax_tree.TMP_MARK not in os.path.basename(p)]
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


def text2vec_resume_path(cp_dir: str, step: int) -> str:
    """What ``--restore_step step`` resumes from: ``checkpoint_{step}.pth.tar``
    where it exists, else the JAX package's orbax ``checkpoint_{step}``
    directory where that exists, else the file's path (whose load raises)."""
    path = text2vec_path(cp_dir, step)
    jax_dir = os.path.join(cp_dir, f"checkpoint_{step}")
    return jax_dir if not os.path.isfile(path) and os.path.isdir(jax_dir) else path


def load_text2vec(path: str, trainer) -> int:
    """Load ``checkpoint_{step}.pth.tar`` into a ``Text2VecTrainer`` built
    with the same config; its step count becomes the step in the file's
    name, as the reference's ``--restore_step`` says.  Returns the file's
    epoch.  A directory is the JAX package's ``T2VTrainState`` (its loop
    keeps no epoch: 0 is returned, and its JAX loop starts from epoch 0
    too): the weights, the LAMB moments ``mu``/``nu`` as ``exp_avg``/
    ``exp_avg_sq``, the learning rate of its ``hyperparams`` and its step."""
    step = checkpoint_step(path)
    if step < 0:
        raise ValueError(f"{path}: no step in the name")
    obj = _load(path)
    if os.path.isdir(path):
        _load_jax_text2vec(path, obj, trainer)
        return 0
    trainer.load_state_dict({"model": obj["model"], "optimizer": obj["optimizer"],
                             "step_count": step})
    return int(obj["epoch"])


def _adam_state(opt_state: Dict[str, Any]) -> Dict[str, Any]:
    """The {count, mu, nu} inside an ``inject_hyperparams`` state: its inner
    state (LAMB's ``ReferenceLambState``), or the first of a chain's states
    that has moments (AdamW's ``ScaleByAdamState``)."""
    inner = opt_state["inner_state"]
    for part in inner if isinstance(inner, list) else [inner]:
        if isinstance(part, dict) and "mu" in part:
            return part
    raise ValueError("an optimizer state without moments (mu, nu)")


def _optimizer_state(optimizer, named: list, opt_state: Dict[str, Any],
                     moments, with_step: bool) -> Dict[str, Any]:
    """``optimizer``'s state dict with the JAX moments in it: ``named``
    [(tag, module)] name the optimizer's parameters, ``moments(tag, tree)``
    maps a moment tree of that module to the port's names.  AdamW takes
    the count as each parameter's ``step``; the learning rate is the one
    in the state's ``hyperparams``."""
    adam = _adam_state(opt_state)
    names = {id(p): (tag, n) for tag, module in named for n, p in module.named_parameters()}
    mu, nu = {}, {}
    for tag, _ in named:
        mu.update({(tag, k): v for k, v in moments(tag, adam["mu"]).items()})
        nu.update({(tag, k): v for k, v in moments(tag, adam["nu"]).items()})
    sd = optimizer.state_dict()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    state, seen = {}, set()
    for i, p in enumerate(params):
        key = names.get(id(p))
        if key not in mu:
            continue
        if mu[key].shape != p.shape:
            raise ValueError(f"moment of {key[1]}: {tuple(mu[key].shape)}, the parameter "
                             f"{tuple(p.shape)}")
        state[i] = {"exp_avg": mu[key], "exp_avg_sq": nu[key]}
        if with_step:
            state[i] = {"step": torch.tensor(float(adam["count"])), **state[i]}
        seen.add(key)
    if seen != set(mu):
        raise ValueError(f"moments of no parameter of the port: {sorted(set(mu) - seen)[:5]}")
    lr = float(opt_state["hyperparams"]["learning_rate"])
    for group in sd["param_groups"]:
        group["lr"] = lr
    sd["state"] = state
    return sd


def _load_jax_text2vec(path: str, tree: Dict[str, Any], trainer) -> None:
    layout = orbax_layout(path)
    if layout != "t2v_state":
        raise ValueError(f"{path} holds {layout}; --restore_step takes a T2VTrainState")
    cfg = trainer.cfg
    model = weights.text2vec_state_dict({"params": tree["params"],
                                         "batch_stats": tree["batch_stats"]}, cfg)
    optim = _optimizer_state(trainer.optimizer, [("t2v", trainer.model)], tree["opt_state"],
                             lambda _, t: weights.param_tensors(t, "text2vec", cfg),
                             with_step=False)
    trainer.load_state_dict({"model": model, "optimizer": optim,
                             "step_count": int(tree["step"])})


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


def newest_vec2wav(cp_dir: str):
    """What ``train-vec2wav`` resumes from under ``cp_dir``: ``("pair",
    (g_path, do_path))`` or ``("jax", state_dir)``, the newer by step (a tie
    goes to the pair), or None."""
    pair, state = latest_vec2wav(cp_dir), scan_checkpoint(cp_dir, "state_")
    if state is not None and (pair is None or checkpoint_step(state) > checkpoint_step(pair[1])):
        return "jax", state
    return None if pair is None else ("pair", pair)


def load_jax_vec2wav(path: str, trainer) -> int:
    """Load the JAX package's ``GANTrainState`` directory into a
    ``GANTrainer`` built with the same config: the Generator (its spectral
    vectors and BatchNorm statistics included), both discriminators and
    the MSD's spectral vectors, and both AdamW states (``mu``, ``nu`` and
    ``count`` as ``exp_avg``, ``exp_avg_sq`` and ``step``; the learning
    rate of their ``hyperparams``).  Returns the next step's number,
    ``state.step + 1``, as the JAX loop resumes (vec2wav_loop.py:160-167)."""
    tree = _load(path)
    layout = orbax_layout(path)
    if layout != "gan_state":
        raise ValueError(f"{path} holds {layout}, not a GANTrainState")
    cfg = trainer.cfg
    gen_sd, mpd_sd, msd_sd = _gan_state_dicts(tree, cfg)
    optim_g = _optimizer_state(trainer.opt_g, [("generator", trainer.gen)], tree["opt_g_state"],
                               lambda _, t: weights.param_tensors(t, "generator", cfg),
                               with_step=True)
    optim_d = _optimizer_state(trainer.opt_d, [("mpd", trainer.mpd), ("msd", trainer.msd)],
                               tree["opt_d_state"],
                               lambda tag, t: weights.param_tensors(t[tag], tag, cfg),
                               with_step=True)
    steps = int(tree["step"]) + 1
    trainer.load_state_dict({"generator": gen_sd, "mpd": mpd_sd, "msd": msd_sd,
                             "optim_g": optim_g, "optim_d": optim_d, "step_count": steps})
    return steps


def _gan_state_dicts(tree: Dict[str, Any], cfg):
    """A ``GANTrainState`` tree's Generator, MPD and MSD as the port's state
    dicts (spectral vectors and BatchNorm statistics included)."""
    disc = tree["disc_params"]
    return (weights.generator_state_dict({"params": tree["gen_params"],
                                          "batch_stats": tree["gen_batch_stats"],
                                          "spectral": tree["gen_spectral"]}, cfg),
            weights.mpd_state_dict({"params": disc["mpd"]}, cfg),
            weights.msd_state_dict({"params": disc["msd"], "spectral": tree["msd_spectral"]}))


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


# --- the JAX package's export-torch ------------------------------------------

def _param_group_stub(sd: Dict[str, torch.Tensor], **hyper) -> Dict[str, Any]:
    """An optimizer state dict with empty per-parameter state, its one
    group's ``params`` covering every trainable tensor of ``sd`` (JAX
    package: ``checkpoint._param_group_stub``): running statistics, batch
    counters and spectral-norm ``weight_u``/``weight_v`` are buffers (a
    ``weight_v`` with a sibling ``weight_g`` is weight norm's parameter)."""
    n = 0
    for k in sd:
        if k.endswith((".running_mean", ".running_var", ".num_batches_tracked", ".weight_u")):
            continue
        if k.endswith(".weight_v") and k[:-len("weight_v")] + "weight_g" not in sd:
            continue
        n += 1
    return {"state": {}, "param_groups": [dict(hyper, params=list(range(n)))]}


def export_text2vec(path: str, tree: Dict[str, Any], cfg, epoch: int = 0) -> None:
    """A ``T2VTrainState`` (or Text2Vec variables) as the reference's
    ``checkpoint_{step}.pth.tar`` at ``path``, as the JAX package's
    ``export-torch`` writes it (``save_reference_text2vec``): the model, an
    optimizer stub at the config's learning rate with empty state (the LAMB
    moments are not carried: the JAX command drops them too; the port's
    loop resumes from the directory itself with them), that rate and
    ``epoch``."""
    sd = weights.text2vec_state_dict({"params": tree["params"],
                                      "batch_stats": tree["batch_stats"]}, cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save(reference_text2vec(sd, cfg, epoch), path)


def reference_text2vec(sd: Dict[str, torch.Tensor], cfg, epoch: int = 0) -> Dict[str, Any]:
    """A Text2Vec state dict as the reference's ``checkpoint_{step}.pth.tar``
    dict, as the JAX package's ``save_reference_text2vec`` writes it: an
    optimizer stub at the config's learning rate, that rate and
    ``epoch``."""
    lr = cfg.learning_rate
    return {"model": sd,
            "optimizer": _param_group_stub(sd, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                           eps=cfg.epsilon, weight_decay=cfg.weight_decay),
            "learning_rate": lr, "epoch": epoch}


def export_vec2wav(cp_dir: str, step: int, tree: Dict[str, Any], cfg, epoch: int = 0) -> None:
    """A ``GANTrainState`` as the reference's ``g_{step:08d}`` and
    ``do_{step:08d}`` under ``cp_dir``, as the JAX package's ``export-torch``
    writes them (``save_reference_vec2wav``), optimizer stubs included."""
    gen_sd, mpd_sd, msd_sd = _gan_state_dicts(tree, cfg)
    adamw = dict(lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8,
                 weight_decay=0.01, amsgrad=False)
    os.makedirs(cp_dir, exist_ok=True)
    torch.save({"generator": gen_sd}, os.path.join(cp_dir, f"g_{step:08d}"))
    torch.save({"mpd": mpd_sd, "msd": msd_sd,
                "optim_g": _param_group_stub(gen_sd, **adamw),
                "optim_d": _param_group_stub({**mpd_sd, **msd_sd}, **adamw),
                "steps": step, "epoch": epoch}, os.path.join(cp_dir, f"do_{step:08d}"))
