"""Text2Vec training loop (JAX package: train/text2vec_loop.py ``main``;
reference: text2vec/train.py:199-455), without checkpoints, logs or
validation yet:

    python -m wavthruvec_pytorch_tpu_torch.train.text2vec_loop \\
        --config data/demo/text2vec.json --max_steps 3 [--device cpu]

It loads ``cfg.train_list`` into host memory, builds a Text2Vec from a
seed, and runs ``max_steps`` training steps over length-bucketed batches,
printing the losses of each.  Paths in the config are relative to the
working directory, as in the JAX package.  It runs on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, load_config
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader, load_buffer
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import SCALAR_KEYS, Text2VecTrainer


def main(cfg: Text2VecConfig, max_steps: int, device=None, seed: int = 0
         ) -> List[Dict[str, float]]:
    """Train for ``max_steps`` steps (over as many epochs as that takes);
    returns each step's losses."""
    device = resolve_device(device)
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    cfg = dataclasses.replace(cfg, vocab_size=frontend.vocab_size)  # as the JAX loop does
    loader = BucketedLoader(load_buffer(list(cfg.train_list), cfg, frontend), cfg, seed=seed)
    if len(loader) == 0:
        raise ValueError(f"{len(loader.buffer)} items make no batch of {cfg.batch_size} x "
                         f"{cfg.batch_expand_size}")
    torch.manual_seed(seed)
    trainer = Text2VecTrainer(cfg, device=device)
    print(f"Number of TTS Parameters: {sum(p.numel() for p in trainer.params)}")
    history: List[Dict[str, float]] = []
    start = time.perf_counter()
    while len(history) < max_steps:
        for batch in loader.epoch():
            metrics = trainer.step(batch)
            values = torch.stack([metrics[k] for k in SCALAR_KEYS]).tolist()
            history.append(dict(zip(SCALAR_KEYS, values)))
            print(f"step {trainer.step_count}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in history[-1].items())
                + f" ({time.perf_counter() - start:.1f} s)")
            if len(history) >= max_steps:
                break
    return history


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True, help="a Text2VecConfig JSON file")
    parser.add_argument("--max_steps", type=int, required=True)
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    parser.add_argument("--seed", type=int, default=0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(load_config(Text2VecConfig, args.config), args.max_steps, device=args.device,
         seed=args.seed)
