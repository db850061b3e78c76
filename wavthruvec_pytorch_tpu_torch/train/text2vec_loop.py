"""Text2Vec training loop (JAX package: train/text2vec_loop.py ``main``;
reference: text2vec/train.py:199-455):

    python -m wavthruvec_pytorch_tpu_torch.train.text2vec_loop \\
        --config data/demo/text2vec.json [--max_steps N] [--restore_step K] \\
        [--validate] [--profile_dir DIR] [--no-precompile] [--device cpu]

It loads ``cfg.train_list`` into host memory (the native reader,
``data/native_io.py``), builds a Text2Vec from a seed and trains over
length-bucketed batches (``--prefetch`` pads the next batch on a thread
while the card runs the step), for ``cfg.epochs`` epochs or up to step
``--max_steps``.  With ``device_resident_data=True`` the corpus is staged on
the card once (``data/device_cache.py``) and each batch is gathered there,
the same batches in the same order; no prefetch thread runs then, and
validation keeps the host loader.  Into ``{run_path}/{log_seed}/`` it
writes:

* ``config.json``, the config;
* ``model_new/checkpoint_{step}.pth.tar`` every ``save_step`` steps, the
  reference's file (``checkpoint.py``); ``--restore_step K`` resumes from
  ``checkpoint_K.pth.tar``, weights, LAMB moments, step count and epoch
  (whose batches it starts over, as the reference does), and raises if the
  file is missing;
* the scalars of every ``--scalar_log_step``-th step, to TensorBoard or
  ``tb_logs/scalars.jsonl`` (``utils/logging.py``), fetched from the card
  in one transfer every ``--metric_flush_steps`` steps and at each log step;
* every ``log_step`` steps a text log (``logger/logger.txt``) and, with a
  TensorBoard writer and matplotlib, item 0's soft and hard alignment
  images;
* with ``--validate``, the eval-mode losses over ``cfg.val_list`` every
  ``val_step`` steps (``compute_validation_loss``).

``--frozen_learning_rate`` holds the lr at ``--learning_rate_frozen``.
``--precompile`` (the default; JAX: its AOT compile of the step programs)
builds and loads every kernel library the step launches before the first
step and prints the seconds; ``--no-precompile`` leaves the build to their
first launch.  ``--profile_dir DIR`` traces the steps JAX's loop traces,
from iteration 3 through the step that starts at iteration 8, with
``torch.profiler`` (CPU activity, and CUDA activity on a card) and writes
the trace to ``DIR/text2vec_rank{rank}.pt.trace.json`` (Chrome's trace
format, which TensorBoard's profiler plugin reads).  Paths in the config
are relative to the working directory, as in the JAX package.  It runs on
the card unless ``--device cpu`` is passed.

Under ``torchrun --nproc_per_node N`` it trains data-parallel, one process
per card (``parallel/mesh.py``; JAX: text2vec_loop.py:150-160): each rank
loads its share of the file lists and steps on ``batch_size / N`` items
padded to the largest bucket pair; every rank builds the model from the
same seed (and loads the same ``--restore_step`` file), then takes rank 0's
state (``globalize_state``); the gradients are averaged before the clip
and LAMB, so the ranks stay equal.  Only rank 0 writes ``config.json``,
checkpoints and logs, and every rank waits for each save.  Validation runs
each rank over its share, and the losses are the global batches' means.
``--dist_backend gloo`` lets ranks share one card (NCCL takes one card a
rank); on the CPU the backend is gloo.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import time
from typing import Dict, Optional

import torch

from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch.config import (
    Text2VecConfig,
    check_ported,
    load_config,
    parse_bool,
    save_config,
)
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader, load_buffer
from wavthruvec_pytorch_tpu_torch.data.device_cache import DeviceResidentData
from wavthruvec_pytorch_tpu_torch.data.prefetch import prefetched
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.fft_block import flash_gate
from wavthruvec_pytorch_tpu_torch.ops import kernel_build
from wavthruvec_pytorch_tpu_torch.parallel.mesh import (
    barrier,
    globalize_state,
    is_main_process,
    local_batch_size,
    maybe_distributed_init,
    rank,
    world_size,
)
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import (
    SCALAR_KEYS,
    VAL_KEYS,
    Text2VecTrainer,
)
from wavthruvec_pytorch_tpu_torch.utils.logging import (
    RunRecord,
    StepTimer,
    TrainLogger,
    host_logger,
)


def compute_validation_loss(trainer: Text2VecTrainer, val_loader: BucketedLoader,
                            logger: TrainLogger, iteration: int) -> Dict[str, float]:
    """The eval-mode losses over the validation set (JAX package:
    ``compute_validation_loss``; reference: text2vec/train.py:80-196, whose
    call is commented out there), averaged over the finite batches only.

    In a process group each rank runs its share of the validation set and
    the step's losses are already the global batch's (``Text2VecTrainer``),
    so every rank sees the same means and counts.

    A batch can go non-finite while training is healthy: eval-mode
    BatchNorm runs on running statistics, LAMB grows the scale-invariant
    convolution weights in front of each BatchNorm (train mode renormalises
    every batch, so the loss never sees it), and an outlier item's
    activations can then overflow f32 in ECAPA's Res2Net trunk.  Such
    batches are counted as ``val/nonfinite_batches`` and left out of the
    means.  Returns the means and ``nonfinite_batches``."""
    totals = dict.fromkeys(VAL_KEYS, 0.0)
    n = bad = 0
    for batch in val_loader.epoch():
        losses = trainer.validation_losses(batch)
        values = torch.stack([losses[k] for k in VAL_KEYS]).tolist()
        if all(math.isfinite(v) for v in values):
            for k, v in zip(VAL_KEYS, values):
                totals[k] += v
            n += 1
        else:
            bad += 1
    if n:
        for k, v in totals.items():
            logger.add_scalar(f"val/{k}", v / n, iteration)
    logger.add_scalar("val/nonfinite_batches", bad, iteration)
    if bad:
        print(f"validation: {bad} non-finite batch(es) at step {iteration} (eval-mode "
              "BatchNorm overflow, see compute_validation_loss)")
    out = {k: v / max(n, 1) for k, v in totals.items()}
    out["nonfinite_batches"] = bad
    return out


# JAX's loop traces the steps it starts at iterations 3 through 8; in the
# trace each is a span named "{PROFILE_SPAN} {iteration}"
PROFILE_START, PROFILE_STOP = 3, 8
PROFILE_SPAN = "text2vec iteration"


def step_kernels(cfg: Text2VecConfig) -> list:
    """The kernel libraries (``ops/kernel_build.py``) a training step launches:
    the BiGRU forward and backward and MAS, and flash attention where the
    config's flash gate can pass at one of its buckets."""
    names = ["gru_fwd", "gru_bwd", "mas"]
    d_k = cfg.decoder_model_dim // cfg.encoder_head  # both stacks take d_v == d_k
    if any(flash_gate(cfg.flash_attention, d_k, d_k, T)
           for T in tuple(cfg.text_buckets) + tuple(cfg.frame_buckets)):
        names.append("flash_attn")
    return names


def precompile(cfg: Text2VecConfig, device: torch.device) -> None:
    """``--precompile``: build and load the step's kernel libraries before
    the first step, the port's counterpart of JAX's AOT compile."""
    if device.type != "cuda":
        print("precompile: nothing to build on the CPU (the step runs the kernels' plain "
              "versions)")
        return
    names = step_kernels(cfg)
    t0 = time.perf_counter()
    kernel_build.build_all(names)
    for name in names:
        kernel_build.load(name)
    print(f"precompiled the step's kernels ({', '.join(names)}) in "
          f"{time.perf_counter() - t0:.1f}s")


def start_profile(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, device: torch.device, profile_dir: str) -> str:
    """Stop the trace and write it into ``profile_dir``; returns its path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"text2vec_rank{rank()}.pt.trace.json")
    prof.export_chrome_trace(path)
    print(f"profile: steps from iteration {PROFILE_START} to {PROFILE_STOP} written to {path}")
    return path


def _validation_loader(cfg: Text2VecConfig, frontend: TextFrontend,
                       seed: int) -> Optional[BucketedLoader]:
    """The validation batches in file order, ``batch_expand_size`` 1 so
    that a set smaller than a super-batch still gives batches."""
    val_lists = [p for p in cfg.val_list if os.path.exists(p)]
    if not val_lists:
        print(f"--validate set but no val list found at {cfg.val_list}")
        return None
    val_cfg = dataclasses.replace(cfg, batch_expand_size=1)
    loader = BucketedLoader(load_buffer(val_lists, cfg, frontend), val_cfg, seed=seed,
                            shuffle=False, batch_size=local_batch_size(cfg.batch_size))
    if len(loader) == 0:
        print(f"validation set too small for batch {cfg.batch_size}")
    return loader


def main(args: Optional[argparse.Namespace] = None,
         cfg: Optional[Text2VecConfig] = None) -> RunRecord:
    """Train as the flags in ``args`` (``parse_args``) say, on ``cfg`` or the
    config file of ``--config``.  Returns the run's record: each step's
    losses, the host seconds between steps (a save's or a validation's
    left out), the saves' and validations' seconds, the validation losses
    and the logger's backend."""
    args = parse_args([]) if args is None else args
    device = (maybe_distributed_init(args.device, args.dist_backend)
              or resolve_device(args.device))
    if cfg is None:
        cfg = load_config(Text2VecConfig, args.config) if args.config else Text2VecConfig()
    check_ported(cfg)
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    cfg = dataclasses.replace(cfg, vocab_size=frontend.vocab_size)  # as the JAX loop does
    loader = BucketedLoader(load_buffer(list(cfg.train_list), cfg, frontend), cfg,
                            seed=args.seed, batch_size=local_batch_size(cfg.batch_size))
    if world_size() > 1:
        print(f"data parallel: rank {rank()} of {world_size()} on {device}, "
              f"{loader.batch_size} items a step of the global {cfg.batch_size}")
    if len(loader) == 0:
        raise ValueError(f"{len(loader.buffer)} items make no batch of {cfg.batch_size} x "
                         f"{cfg.batch_expand_size}")
    torch.manual_seed(args.seed)
    trainer = Text2VecTrainer(cfg, device=device)
    print(f"Number of TTS Parameters: {sum(p.numel() for p in trainer.params)}")
    if args.precompile:
        precompile(cfg, device)

    # resume (reference: --restore_step and checkpoint_{step}, train.py:237-248)
    iteration, first_epoch = 0, 0
    if args.restore_step > 0:
        first_epoch = ckpt.load_text2vec(
            ckpt.text2vec_path(cfg.checkpoint_path, args.restore_step), trainer)
        iteration = args.restore_step
        print(f"\n---Model Restored at Step {args.restore_step}---\n")
    if args.frozen_learning_rate:  # after the restore, which loads the saved lr
        trainer.set_learning_rate(args.learning_rate_frozen)
    globalize_state([trainer.model], [trainer.optimizer])
    if world_size() > 1:  # each rank its own dropout stream
        torch.manual_seed(args.seed + rank())

    if is_main_process():
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        save_config(cfg, os.path.join(cfg.run_path, cfg.log_seed, "config.json"))
    logger = host_logger(cfg.tensorboard_logs_path, cfg.logger_path)
    record = RunRecord(backend=logger.backend)
    print(f"logger: {logger.backend} ({cfg.tensorboard_logs_path})")
    timer = StepTimer()
    val_loader = _validation_loader(cfg, frontend, args.seed) if args.validate else None
    device_data = None
    if cfg.device_resident_data:
        device_data = DeviceResidentData(loader.buffer, cfg, device=device)  # this rank's share
        print(f"device-resident dataset: {device_data.nbytes() / 2**20:.0f} MiB staged on "
              f"{device}")

    total_step = cfg.epochs * len(loader)
    print(f"\ntotal steps: {total_step} len(loader) {len(loader)}\n")
    start_time = time.perf_counter()
    # each step's scalars stay on the card until a flush fetches them all in
    # one transfer; a log step's entry also holds item 0's alignment maps
    pend = []

    def emit(p, row):
        it = p["it"]
        record.steps[it] = dict(zip(SCALAR_KEYS, row))
        if p["seconds"] is not None:
            record.seconds[it] = p["seconds"]
        if it % args.scalar_log_step == 0:
            for tag, v in zip(SCALAR_KEYS, row):
                logger.add_scalar(f"train/{tag}", v, it)
        if it % cfg.log_step == 0:
            logger.text(
                f"Epoch [{p['epoch'] + 1}/{cfg.epochs}], Step [{it}/{total_step}]:",
                f"W2V Feat Loss: {row[1]:.4f}, PostNet Loss: {row[2]:.4f}, "
                f"attn_bin: {row[4]:.4f};",
                f"Current Learning Rate is {p['lr']:.6f}.",
                f"Time Used: {time.perf_counter() - start_time:.3f}s, Estimated Remaining: "
                f"{(total_step - it) * timer.mean:.3f}s.")
            if p["viz"] is not None:
                from wavthruvec_pytorch_tpu_torch.utils.plots import plot_alignment_to_numpy

                title = os.path.basename(p["audiopath"])
                for tag, m in zip(("train/attention_weights(align_soft)",
                                   "train/attention_weights_mas(align_hard)"), p["viz"]):
                    logger.add_image(tag, plot_alignment_to_numpy(m, title=title), it)

    def flush():
        if pend:
            rows = torch.stack([p["scalars"] for p in pend]).tolist()
            for p, row in zip(pend, rows):
                emit(p, row)
            pend.clear()

    def batches():
        for idx in loader.epoch_indices():
            batch = (loader.batch(idx) if device_data is None
                     else device_data.batch(idx, pad_to_max=loader.pad_to_max))
            yield loader.buffer[idx[0]]["audiopath"], batch

    profiler = None
    try:
        if args.max_steps and iteration >= args.max_steps:
            print(f"step {iteration} has reached --max_steps {args.max_steps}: nothing to train")
            return record
        for epoch in range(first_epoch, cfg.epochs):
            prefetch = args.prefetch and device_data is None
            with contextlib.closing(prefetched(batches(), enabled=prefetch)) as epoch_batches:
                for audiopath, batch in epoch_batches:
                    is_log_step = (iteration + 1) % cfg.log_step == 0
                    lr = trainer.learning_rate
                    if args.profile_dir and iteration == PROFILE_START:
                        profiler = start_profile(device)
                    with (torch.profiler.record_function(f"{PROFILE_SPAN} {iteration}")
                          if profiler is not None else contextlib.nullcontext()):
                        total, metrics, out = trainer.forward(trainer.to_device(batch))
                        trainer.backward(total)
                        trainer.apply_gradients()
                    if profiler is not None and iteration == PROFILE_STOP:
                        stop_profile(profiler, device, args.profile_dir)
                        profiler = None
                    iteration += 1
                    viz = None
                    if is_log_step and logger.takes_figures:
                        # item 0's maps reach the host on log steps only
                        n, t = int(batch["input_lengths"][0]), int(batch["output_lengths"][0])
                        viz = [out[k][0, :t, :n].T.detach().float().cpu().numpy()
                               for k in ("attn_soft", "attn")]
                    del total, out
                    pend.append({"it": iteration, "epoch": epoch, "lr": lr, "viz": viz,
                                 "audiopath": audiopath, "seconds": timer.tick(),
                                 "scalars": torch.stack([metrics[k] for k in SCALAR_KEYS])})
                    if len(pend) >= args.metric_flush_steps or is_log_step:
                        flush()

                    if iteration % cfg.save_step == 0:
                        t0 = time.perf_counter()
                        if is_main_process():
                            ckpt.save_text2vec(
                                ckpt.text2vec_path(cfg.checkpoint_path, iteration), trainer,
                                epoch)
                        barrier()
                        record.saves[iteration] = time.perf_counter() - t0
                        print(f"save model at step {iteration} "
                              f"({record.saves[iteration]:.2f} s)")
                    if val_loader is not None and iteration % cfg.val_step == 0:
                        t0 = time.perf_counter()
                        vals = compute_validation_loss(trainer, val_loader, logger, iteration)
                        record.validations[iteration] = dict(
                            vals, seconds=time.perf_counter() - t0)
                        logger.text(f"Validation at step {iteration}: "
                                    + ", ".join(f"{k}: {v:.4f}" for k, v in vals.items()))
                    if iteration in record.saves or iteration in record.validations:
                        timer.restart()
                    if args.max_steps and iteration >= args.max_steps:
                        return record
    finally:
        # on any exit the last steps' scalars are written, a trace still open
        # is written, and the logs flushed
        if profiler is not None:
            stop_profile(profiler, device, args.profile_dir)
        flush()
        logger.close()
    return record


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="a Text2VecConfig JSON file (e.g. data/demo/text2vec.json)")
    parser.add_argument("--restore_step", type=int, default=0,
                        help="resume from model_new/checkpoint_{step}.pth.tar")
    parser.add_argument("--frozen_learning_rate", type=parse_bool, default=False,
                        help="true/false: hold the lr at --learning_rate_frozen")
    parser.add_argument("--learning_rate_frozen", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=0,
                        help="stop after this step; a run restored at or past it trains "
                        "nothing (0: train cfg.epochs epochs)")
    parser.add_argument("--scalar_log_step", type=int, default=1)
    parser.add_argument("--metric_flush_steps", type=int, default=20,
                        help="fetch the steps' scalars from the card in one transfer every "
                        "this many steps (and at each log step)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="trace the steps from iteration 3 to 8 with torch.profiler into "
                        "DIR/text2vec_rank{rank}.pt.trace.json")
    parser.add_argument("--precompile", action=argparse.BooleanOptionalAction, default=True,
                        help="build and load the step's kernels before the first step "
                        "(--no-precompile: at their first launch)")
    parser.add_argument("--prefetch", action=argparse.BooleanOptionalAction, default=True,
                        help="pad the next batch on a thread while the card runs the step")
    parser.add_argument("--validate", action="store_true",
                        help="validate every cfg.val_step steps")
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    parser.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="the process group's backend under torchrun (default: nccl on "
                        "the card, gloo on the CPU; gloo lets ranks share one card)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
