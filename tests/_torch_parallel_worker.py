"""The ranks' side of the port's data-parallel tests (``test_torch_parallel*.py``):
functions that ``parallel.launch.run_local`` runs in spawned processes, two
ranks over gloo on the CPU.  This module imports no JAX; the tests compute
JAX's side in their own process and hand the ranks numpy arrays.  It also
holds ``torch_one_thread``, a fixture those tests import."""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm
from wavthruvec_pytorch_tpu_torch.models.losses import attention_binarization_loss
from wavthruvec_pytorch_tpu_torch.models.text2vec import Text2Vec
from wavthruvec_pytorch_tpu_torch.parallel import mesh
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import BATCH_KEYS, Text2VecTrainer
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer

# every how many elements a discriminator tensor is sampled for the parent
D_SAMPLE = 101


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """Torch on one thread for a test module that imports this fixture: the
    suite's workers share the host's cores, and torch's spinning thread
    pool slows every worker when the cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(tensors) -> str:
    """One hash of the tensors' bytes: equal on two ranks only if every
    tensor is bit-equal."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _join():
    if mesh.group_active():
        return
    torch.set_num_threads(1)  # two ranks share the test worker's cores
    dev = mesh.maybe_distributed_init("cpu")
    assert dev == torch.device("cpu") and mesh.world_size() == 2
    return dev


def batch_norm(x: np.ndarray, cot: np.ndarray, state: dict):
    """Train-mode BatchNorm on this rank's rows of ``x``; the loss is
    ``sum(y * cot)`` over the global batch.  Returns this rank's output and
    input gradient, the parameter gradients summed over the ranks (the
    global loss's), and the running statistics."""
    _join()
    world = mesh.mesh_for_batch(len(x))
    local = mesh.shard_batch({"x": x, "cot": cot}, world)
    bn = BatchNorm(x.shape[-1], device="cpu").train()
    bn.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    xt = local["x"].requires_grad_()
    y = bn(xt)
    (y * local["cot"]).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    mesh.all_reduce_mean(grads)
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dweight": grads[0].numpy() * 2, "dbias": grads[1].numpy() * 2,
            "running_mean": bn.running_mean.numpy(), "running_var": bn.running_var.numpy()}


def all_steps(bn_args: tuple, t2v_args: tuple, gan_args: tuple):
    """``batch_norm``, ``text2vec_steps`` and ``gan_step`` in one pair of
    ranks."""
    return batch_norm(*bn_args), text2vec_steps(*t2v_args), gan_step(*gan_args)


def text2vec_steps(cfg_fields: dict, start: dict, batches: list):
    """For each global batch: a Text2Vec trainer from ``start``, made
    global, one step on this rank's rows.  Returns, a batch each, the
    step's (global) losses, this rank's own binarization ratio, the
    averaged and clipped gradients, the parameters after LAMB and their
    digest."""
    _join()
    cfg = Text2VecConfig(**cfg_fields)
    out = []
    for batch in batches:
        world = mesh.mesh_for_batch(len(batch["text"]))
        model = Text2Vec(cfg, device="cpu")
        model.load_state_dict({k: torch.as_tensor(v) for k, v in start.items()}, strict=True)
        trainer = Text2VecTrainer(cfg, device="cpu", model=model)
        mesh.globalize_state([model], [trainer.optimizer])
        local = mesh.shard_batch({k: batch[k] for k in BATCH_KEYS}, world)
        total, metrics, res = trainer.forward(trainer.to_device(local))
        own = attention_binarization_loss(res["attn"], res["attn_soft"]).item()
        trainer.backward(total)
        trainer.apply_gradients()
        state = model.state_dict()
        out.append({
            "losses": [metrics[k].item() for k in metrics], "own_binarization": own,
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None},
            "state": {k: v.numpy() for k, v in state.items()},
            "digest": digest(state.values())})
    return out


def gan_step(cfg_fields: dict, batch: dict, seed: int = 0):
    """A ``GANTrainer`` built from ``seed`` (as the one-process side builds
    it), one step on this rank's rows of ``batch``, noise from the trainer's
    own stream.  Returns the losses, the Generator's gradients and
    parameters, every ``D_SAMPLE``-th element of each discriminator
    gradient and parameter, the spectral vectors, and a digest of every
    module state."""
    _join()
    cfg = Vec2WavConfig(**cfg_fields)
    torch.manual_seed(seed)
    trainer = GANTrainer(cfg, device="cpu", seed=seed)
    mesh.globalize_state([trainer.gen, trainer.mpd, trainer.msd],
                         [trainer.opt_g, trainer.opt_d])
    world = mesh.mesh_for_batch(len(batch["audio"]))
    metrics = trainer.step(mesh.shard_batch(batch, world))
    disc = [(f"mpd.{n}", p) for n, p in trainer.mpd.named_parameters()] + \
        [(f"msd.{n}", p) for n, p in trainer.msd.named_parameters()]
    return {
        "losses": [metrics[k].item() for k in SCALAR_KEYS],
        "gen_grads": {n: p.grad.numpy() for n, p in trainer.gen.named_parameters()
                      if p.grad is not None},
        "gen": {n: v.numpy() for n, v in trainer.gen.state_dict().items()},
        "disc_grads": {n: p.grad.flatten()[::D_SAMPLE].numpy() for n, p in disc},
        "disc": {n: p.detach().flatten()[::D_SAMPLE].numpy() for n, p in disc},
        "spectral": {n: v.numpy() for m in (trainer.gen, trainer.msd)
                     for n, v in m.state_dict().items() if n.endswith(("_u", "_v", ".u", ".v"))},
        "digest": digest([*trainer.gen.state_dict().values(), *trainer.mpd.state_dict().values(),
                          *trainer.msd.state_dict().values()]),
    }


def train_loop(stage: str, argv: list, cfg, workdir: str):
    """``text2vec_loop.main`` or ``vec2wav_loop.main`` with ``argv`` and
    ``cfg``, from ``workdir``, logging to JSONL.  Returns the run record's
    steps and saves and the files this rank wrote: checkpoints,
    ``config.json`` and loggers opened."""
    _join()
    os.chdir(workdir)
    sys.modules["torch.utils.tensorboard"] = None  # the JSONL logger
    from wavthruvec_pytorch_tpu_torch import checkpoint
    from wavthruvec_pytorch_tpu_torch.utils import logging

    if stage == "t2v":
        from wavthruvec_pytorch_tpu_torch.train import text2vec_loop as loop
    else:
        from wavthruvec_pytorch_tpu_torch.train import vec2wav_loop as loop
    written = []
    save, save_config, logger_cls = checkpoint._save, loop.save_config, logging.TrainLogger

    def recording(fn, what):
        def wrapped(*args, **kwargs):
            written.append(what(*args))
            return fn(*args, **kwargs)
        return wrapped

    checkpoint._save = recording(save, lambda obj, path: os.path.basename(path))
    loop.save_config = recording(save_config, lambda cfg, path: os.path.basename(path))
    logging.TrainLogger = recording(logger_cls, lambda *a: "logger")
    try:
        record = loop.main(loop.parse_args(argv), cfg=cfg)
    finally:
        checkpoint._save, loop.save_config, logging.TrainLogger = save, save_config, logger_cls
    return {"steps": record.steps, "saves": sorted(record.saves), "written": written}


def train_loops(jobs: list):
    """``train_loop`` for each ``(stage, argv, cfg, workdir)`` in turn."""
    return [train_loop(*job) for job in jobs]
