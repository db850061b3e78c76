"""The port's Vec2Wav training loop on the CPU (split from
``test_torch_gan.py``, whose GAN modules it trains, so that the suite's
workers run it beside that file's parity tests): ``vec2wav_loop.main`` with
the tiny demo config."""

import dataclasses
import os
import sys

import numpy as np

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.train import vec2wav_loop
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_vec2wav_loop_cpu(monkeypatch, tmp_path):
    """``vec2wav_loop.main`` for 3 steps with the tiny demo config on the
    CPU (its run directory under a temporary one, its scalars to JSONL):
    finite scalars, over two epochs' lr (batch size 5 of 10 items)."""
    monkeypatch.chdir(REPO)
    # the JSONL logger: TensorBoard's import would load TensorFlow where it is installed
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = dataclasses.replace(load_config(Vec2WavConfig, "data/demo/vec2wav_tiny.json"),
                              batch_size=5, run_path=str(tmp_path))
    history = vec2wav_loop.main(vec2wav_loop.parse_args(["--max_steps", "3", "--device", "cpu"]),
                                cfg=cfg).steps
    assert len(history) == 3
    assert all(set(h) == set(SCALAR_KEYS) and all(np.isfinite(list(h.values())))
               for h in history.values())
