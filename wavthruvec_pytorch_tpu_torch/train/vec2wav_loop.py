"""Vec2Wav GAN training loop (JAX package: train/vec2wav_loop.py ``main``;
reference: vec2wav/train.py:57-335), without checkpoints, logs or
validation yet:

    python -m wavthruvec_pytorch_tpu_torch.train.vec2wav_loop \\
        --config data/demo/vec2wav.json --max_steps 3 [--device cpu]

It reads ``cfg.input_training_file``, builds a ``GANTrainer`` from a seed
(``cfg.seed`` unless ``seed`` is given) and runs ``max_steps`` D/G steps over
batches padded to the config's frame buckets, setting the learning rate to
``learning_rate * lr_decay ** epoch`` at each epoch and printing each step's
losses.  Paths in the config are relative to the working directory, as in
the JAX package.  It runs on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import (
    VocoderDataset,
    VocoderLoader,
    get_dataset_filelist,
)
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS, GANTrainer


def main(cfg: Vec2WavConfig, max_steps: int, device=None, seed: Optional[int] = None
         ) -> List[Dict[str, float]]:
    """Train for ``max_steps`` steps (over as many epochs as that takes);
    returns each step's losses."""
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    training_files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    loader = VocoderLoader(VocoderDataset(training_files, cfg), cfg.batch_size, seed=seed)
    if len(loader) == 0:
        raise ValueError(f"{len(training_files)} items make no batch of {cfg.batch_size}")
    torch.manual_seed(seed)
    trainer = GANTrainer(cfg, device=device, seed=seed)
    print(f"Number of Generator parameters: {sum(p.numel() for p in trainer.gen_params)}, "
          f"discriminators: {sum(p.numel() for p in trainer.disc_params)}")
    history: List[Dict[str, float]] = []
    start = time.perf_counter()
    epoch = 0
    while len(history) < max_steps:
        trainer.set_learning_rate(cfg.learning_rate * cfg.lr_decay ** epoch)
        for batch in loader.epoch():
            metrics = trainer.step(batch)
            values = torch.stack([metrics[k] for k in SCALAR_KEYS]).tolist()
            history.append(dict(zip(SCALAR_KEYS, values)))
            print(f"epoch {epoch + 1} step {trainer.step_count}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in history[-1].items())
                + f" ({time.perf_counter() - start:.1f} s)")
            if len(history) >= max_steps:
                break
        epoch += 1
    return history


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="a Vec2WavConfig JSON file")
    parser.add_argument("--max_steps", type=int, required=True)
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    parser.add_argument("--seed", type=int, default=None, help="default: the config's seed")
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(load_config(Vec2WavConfig, args.config), args.max_steps, device=args.device,
         seed=args.seed)
