"""Vec2Wav GAN training loop (JAX package: train/vec2wav_loop.py ``main``,
``validate``; reference: vec2wav/train.py:57-335):

    python -m wavthruvec_pytorch_tpu_torch.train.vec2wav_loop \\
        --config data/demo/vec2wav.json [--max_steps N] [--training_epochs E] \\
        [--device cpu]

It reads ``cfg.input_training_file``, builds a ``GANTrainer`` from
``cfg.seed`` and runs D/G steps over batches of whole utterances padded to
the config's frame buckets, or of windows with ``split=True``, setting the
learning rate to ``learning_rate * lr_decay ** epoch`` at each epoch.  Steps
are numbered from 0, as the reference numbers them.  Into
``{run_path}/{log_seed}/`` it writes:

* ``config.json``, the config;
* ``model_new/g_{step:08d}`` and ``do_{step:08d}`` every ``save_step``
  steps and after the last step of ``--max_steps``, the reference's files
  (``checkpoint.py``); a run resumes from the newest pair it finds there,
  weights, spectral vectors, AdamW moments, step and epoch (whose batches
  it starts over, as the reference does);
* the G loss and mel error every ``log_step`` steps, to TensorBoard or
  ``tb_logs/scalars.jsonl`` (``utils/logging.py``);
* every ``val_step`` steps the validation's mel L1 over at most 16 whole
  utterances of ``cfg.input_validation_file`` (``validate``), with audio
  when there is a TensorBoard writer and spectrogram figures when
  matplotlib is there too.

``--stdout_interval`` prints a step's losses; ``--num_workers`` threads
load a batch's items and ``--prefetch`` loads the next batch while the card
runs the step.  ``--fine_tuning`` and ``--input_mels_dir`` select the
reference's branch of precomputed mels (``data/vocoder_data.py``).
``--group_name``, ``--input_wavs_dir`` and ``--validation_interval`` parse
and select nothing, as in the JAX loop, which declares and ignores them.  With
``device_resident_data=True``, ``split=True`` and ``device_mel_target=True``
and without ``--fine_tuning``, the corpus is staged on the card once
(``data/vocoder_device_cache.py``) and each step's windows are gathered
there, the batches in the host loader's order; no prefetch thread runs then.
Otherwise the flag is ignored, with a message, as in the JAX package.
Validation keeps the host path.  It runs on the card unless ``--device
cpu`` is passed.

Under ``torchrun --nproc_per_node N`` it trains data-parallel, one process
per card (``parallel/mesh.py``; JAX: vec2wav_loop.py:128-241): each rank
reads its share of the training files (``process_shard``; with
``device_resident_data`` it stages that share on its card) and steps on
``batch_size / N`` items, padded to the largest frame bucket in
full-utterance mode; every rank resumes from the same newest pair, then
takes rank 0's state (``globalize_state``); the D and G gradients are
averaged before each AdamW step.  Only rank 0 writes ``config.json``,
checkpoints and logs, and every rank waits for each save; every rank
validates the same items, rank 0 logs them.  ``--dist_backend gloo`` lets
ranks share one card.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch import checkpoint as ckpt
from wavthruvec_pytorch_tpu_torch.config import (
    Vec2WavConfig,
    load_config,
    parse_bool,
    save_config,
)
from wavthruvec_pytorch_tpu_torch.data.prefetch import prefetched
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import (
    VocoderDataset,
    VocoderLoader,
    get_dataset_filelist,
    pad_vocoder_batch,
)
from wavthruvec_pytorch_tpu_torch.data.vocoder_device_cache import VocoderDeviceData
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.parallel.mesh import (
    barrier,
    globalize_state,
    is_main_process,
    local_batch_size,
    maybe_distributed_init,
    process_shard,
    rank,
    world_size,
)
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer, log_mel
from wavthruvec_pytorch_tpu_torch.utils.logging import RunRecord, TrainLogger, host_logger

# the utterances a validation runs over, at most (reference: train.py:250)
VAL_ITEMS = 16


@torch.no_grad()
def validate(trainer: GANTrainer, validset: VocoderDataset, logger: TrainLogger, steps: int,
             max_items: int = 4, noise: Optional[np.ndarray] = None) -> float:
    """The reference's validation (vec2wav/train.py:246-291; JAX package:
    ``validate``): the trained Generator in eval mode (its BatchNorms on
    running statistics, no power iteration) synthesises each of the first
    ``VAL_ITEMS`` items, padded alone to its frame bucket; the mel L1 to the
    item's host mel over their common frames, averaged over the items, is
    logged as ``validation/mel_spec_error`` and returned.  The audio of the
    first ``max_items`` goes to TensorBoard when there is a writer, their
    spectrograms when matplotlib is there too.  ``noise`` [items,
    noise_dim] replaces the draws of a CPU ``torch.Generator`` seeded
    ``steps``."""
    cfg, gen = trainer.cfg, trainer.gen
    n = min(len(validset), VAL_ITEMS)
    if noise is None:
        noise = torch.randn((n, cfg.noise_dim),
                            generator=torch.Generator().manual_seed(steps)).numpy()
    gen.eval()
    errs = []
    try:
        for j in range(n):
            batch = pad_vocoder_batch([validset[j]], cfg)
            feat, spk, y_mel, z = (torch.as_tensor(a).to(trainer.device) for a in (
                batch["wv_feat"], batch["spk_emb"], batch["mel_loss"], noise[j:j + 1]))
            y_hat = gen(feat, spk, z)
            y_hat_mel = log_mel(cfg, y_hat)
            m = min(y_mel.shape[1], y_hat_mel.shape[1])
            errs.append(torch.mean(torch.abs(y_mel[:, :m] - y_hat_mel[:, :m])))
            if j < max_items and logger.tb is not None:
                logger.add_audio(f"generated/y_hat_{j}", y_hat[0, :, 0][None].cpu(), steps,
                                 cfg.sampling_rate)
            if j < max_items and logger.takes_figures:
                from wavthruvec_pytorch_tpu_torch.utils.plots import plot_spectrogram

                logger.add_figure(f"generated/y_hat_spec_{j}",
                                  plot_spectrogram(y_hat_mel[0].T.cpu().numpy()), steps)
    finally:
        gen.train()
    err = torch.stack(errs).mean().item() if errs else 0.0
    if errs:
        logger.add_scalar("validation/mel_spec_error", err, steps)
    return err


def main(args: Optional[argparse.Namespace] = None,
         cfg: Optional[Vec2WavConfig] = None) -> RunRecord:
    """Train as the flags in ``args`` (``parse_args``) say, on ``cfg`` or the
    config file of ``--config``.  Returns the run's record: each step's
    losses, the saves' and validations' seconds, the validation errors and
    the logger's backend."""
    args = parse_args([]) if args is None else args
    device = (maybe_distributed_init(args.device, args.dist_backend)
              or resolve_device(args.device))
    if cfg is None:
        cfg = load_config(Vec2WavConfig, args.config) if args.config else Vec2WavConfig()
    print("Initializing Training Process..")
    training_files, validation_files = get_dataset_filelist(cfg.input_training_file,
                                                            cfg.input_validation_file)
    training_files = process_shard(training_files)
    trainset = VocoderDataset(training_files, cfg, fine_tuning=args.fine_tuning,
                              base_mels_path=args.input_mels_dir)
    loader = VocoderLoader(trainset, local_batch_size(cfg.batch_size), seed=cfg.seed,
                           num_workers=args.num_workers)
    if world_size() > 1:
        print(f"data parallel: rank {rank()} of {world_size()} on {device}, "
              f"{loader.batch_size} items a step of the global {cfg.batch_size}")
    if len(loader) == 0:
        raise ValueError(f"{len(training_files)} items make no batch of {cfg.batch_size}")
    # validation compares mels on the host, over whole utterances
    validset = VocoderDataset(validation_files, cfg, fine_tuning=args.fine_tuning,
                              base_mels_path=args.input_mels_dir, split=False, compute_mel=True)
    torch.manual_seed(cfg.seed)
    trainer = GANTrainer(cfg, device=device, seed=cfg.seed)
    print(f"Number of Generator parameters: {sum(p.numel() for p in trainer.gen_params)}, "
          f"discriminators: {sum(p.numel() for p in trainer.disc_params)}")

    # auto-resume from the newest g_/do_ pair (reference: train.py:74-89), on
    # every rank from the same files
    steps, first_epoch = 0, 0
    latest = ckpt.latest_vec2wav(cfg.checkpoint_path)
    if latest is not None:
        resumed = ckpt.load_vec2wav(*latest, trainer)
        steps, first_epoch = resumed["steps"], resumed["epoch"]
        print(f"resumed from {latest[1]} at step {steps}, epoch {first_epoch + 1}")
    globalize_state([trainer.gen, trainer.mpd, trainer.msd], [trainer.opt_g, trainer.opt_d])

    if is_main_process():
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        save_config(cfg, os.path.join(cfg.run_path, cfg.log_seed, "config.json"))
    logger = host_logger(cfg.tensorboard_logs_path, cfg.logger_path)
    record = RunRecord(backend=logger.backend)
    print(f"logger: {logger.backend} ({cfg.tensorboard_logs_path})")
    # each step's scalars stay on the card until a step that prints or logs
    pend = []

    def flush():
        if pend:
            rows = torch.stack([v for _, v in pend]).tolist()
            for (s, _), row in zip(pend, rows):
                record.steps[s] = dict(zip(SCALAR_KEYS, row))
            pend.clear()

    device_data = None
    if cfg.device_resident_data:
        if trainset.split and not args.fine_tuning and cfg.device_mel_target:
            device_data = VocoderDeviceData(trainset, cfg, device=device)
            print(f"device-resident dataset: {device_data.nbytes() / 2**20:.0f} MiB staged on "
                  f"{device}")
        else:
            print("device_resident_data ignored (needs split=True, no fine_tuning, "
                  "device_mel_target=True)")

    def batches():
        if device_data is None:
            return prefetched(loader.epoch(), enabled=args.prefetch)
        return (device_data.batch(idx) for idx in loader.epoch_indices())

    def save(epoch):
        t0 = time.perf_counter()
        if is_main_process():
            ckpt.save_vec2wav(cfg.checkpoint_path, steps, trainer, epoch)
        barrier()
        record.saves[steps] = time.perf_counter() - t0

    try:
        if args.max_steps and steps >= args.max_steps:
            print(f"{steps} steps have reached --max_steps {args.max_steps}: nothing to train")
            return record
        for epoch in range(first_epoch, args.training_epochs):
            start = time.time()
            print(f"Epoch: {epoch + 1}")
            trainer.set_learning_rate(cfg.learning_rate * cfg.lr_decay ** epoch)
            with contextlib.closing(batches()) as epoch_batches:
                for batch in epoch_batches:
                    start_b = time.time()
                    metrics = trainer.step(batch)
                    pend.append((steps, torch.stack([metrics[k] for k in SCALAR_KEYS])))
                    if steps % args.stdout_interval == 0 or steps % cfg.log_step == 0:
                        flush()
                        row = record.steps[steps]
                        record.seconds[steps] = time.time() - start_b
                    if steps % args.stdout_interval == 0:
                        print(f"Steps : {steps:d}, Gen Loss Total : {row['gen_loss_total']:4.3f}, "
                              f"Mel-Spec. Error : {row['mel_spec_error']:4.3f}, s/b : "
                              f"{record.seconds[steps]:4.3f}")
                    if steps % cfg.save_step == 0 and steps != 0:
                        save(epoch)
                    if steps % cfg.log_step == 0:
                        logger.add_scalar("training/gen_loss_total", row["gen_loss_total"], steps)
                        logger.add_scalar("training/mel_spec_error", row["mel_spec_error"], steps)
                    if steps % cfg.val_step == 0 and steps != 0:
                        t0 = time.perf_counter()
                        err = validate(trainer, validset, logger, steps)
                        record.validations[steps] = {"mel_spec_error": err,
                                                     "seconds": time.perf_counter() - t0}
                    if args.max_steps and steps + 1 >= args.max_steps:
                        if steps % cfg.save_step != 0 or steps == 0:  # the last step's files
                            save(epoch)
                        return record
                    steps += 1
            print(f"Time taken for epoch {epoch + 1} is {int(time.time() - start)} sec\n")
    finally:
        flush()
        loader.close()
        logger.close()
    return record


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default="",
                        help="a Vec2WavConfig JSON file (e.g. data/demo/vec2wav.json)")
    parser.add_argument("--group_name", default=None,
                        help="read by nothing, as in the JAX loop (the reference's "
                        "distributed group name)")
    parser.add_argument("--input_wavs_dir", default="LJSpeech-1.1/wavs",
                        help="read by nothing, as in the JAX loop: the wavs come from the "
                        "config's file lists")
    parser.add_argument("--input_mels_dir", default="ft_dataset",
                        help="the precomputed mels of --fine_tuning")
    parser.add_argument("--training_epochs", default=100, type=int)
    parser.add_argument("--stdout_interval", default=50, type=int)
    parser.add_argument("--validation_interval", default=1000, type=int,
                        help="read by nothing, as in the JAX loop: validation runs every "
                        "cfg.val_step steps")
    parser.add_argument("--fine_tuning", default=False, type=parse_bool,
                        help="true/false: train on the precomputed mels of --input_mels_dir")
    parser.add_argument("--max_steps", type=int, default=0,
                        help="stop after this many steps in all, a resumed run's included "
                        "(0: train --training_epochs epochs)")
    parser.add_argument("--num_workers", type=int, default=4,
                        help="threads loading the items of a batch")
    parser.add_argument("--prefetch", action=argparse.BooleanOptionalAction, default=True,
                        help="load the next batch on a thread while the card runs the step")
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    parser.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="the process group's backend under torchrun (default: nccl on "
                        "the card, gloo on the CPU; gloo lets ranks share one card)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
