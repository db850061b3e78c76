"""The training loops' logs (JAX package: utils/logging.py ``TrainLogger``,
``StepTimer``; reference: text2vec/train.py:363-422, vec2wav/train.py:241-289).

Scalars, images, audio and figures go to a TensorBoard ``SummaryWriter``
when ``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package); otherwise scalars are appended to ``scalars.jsonl`` in the same
directory, one ``{"tag", "value", "step"}`` object a line, and images,
audio and figures are dropped: they have nowhere to go.  The loops draw
images and figures only when ``takes_figures`` says the writer is there and
matplotlib can be imported.  Text lines are printed and appended to
``logger.txt``.  Under data parallelism only rank 0 writes logs
(``host_logger``; JAX package: utils/logging.py:85).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time
from typing import Dict, List, Optional


class TrainLogger:
    def __init__(self, tb_dir: str, text_dir: str):
        os.makedirs(tb_dir, exist_ok=True)
        os.makedirs(text_dir, exist_ok=True)
        self.text_path = os.path.join(text_dir, "logger.txt")
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tb = None
            self._jsonl = open(os.path.join(tb_dir, "scalars.jsonl"), "a", encoding="utf-8")
        else:
            self.tb = SummaryWriter(tb_dir)
        self.takes_figures = (self.tb is not None
                              and importlib.util.find_spec("matplotlib") is not None)

    @property
    def backend(self) -> str:
        if self.tb is None:
            return "jsonl"
        return "tensorboard" + ("" if self.takes_figures else " (no figures: no matplotlib)")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.tb is not None:
            self.tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": step})
                              + "\n")

    def add_image(self, tag: str, image_hwc, step: int) -> None:
        if self.tb is not None:
            self.tb.add_image(tag, image_hwc, step, dataformats="HWC")

    def add_audio(self, tag: str, wav, step: int, sample_rate: int) -> None:
        if self.tb is not None:
            import torch

            self.tb.add_audio(tag, torch.as_tensor(wav), step, sample_rate)

    def add_figure(self, tag: str, fig, step: int) -> None:
        if self.tb is not None:
            self.tb.add_figure(tag, fig, step)

    def text(self, *lines: str) -> None:
        for line in lines:
            print(line)
        with open(self.text_path, "a", encoding="utf-8") as f:
            for line in lines:
                f.write(line + "\n")
            f.write("\n")

    def flush(self) -> None:
        if self.tb is not None:
            self.tb.flush()
        else:
            self._jsonl.flush()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        else:
            self._jsonl.close()


class NullLogger:
    """The logger of a rank other than 0: it writes nothing."""

    tb = None
    takes_figures = False
    backend = "none (not rank 0)"

    def add_scalar(self, *args, **kwargs) -> None:
        pass

    add_image = add_audio = add_figure = text = add_scalar

    def flush(self) -> None:
        pass

    close = flush


def host_logger(tb_dir: str, text_dir: str):
    """A ``TrainLogger`` on rank 0 (or the only process), a ``NullLogger``
    on the other ranks."""
    from wavthruvec_pytorch_tpu_torch.parallel.mesh import is_main_process

    return TrainLogger(tb_dir, text_dir) if is_main_process() else NullLogger()


class StepTimer:
    """Rolling mean of the wall time between ``tick`` calls (reference:
    text2vec/train.py's Time/clear_Time bookkeeping, lines 276, 442-448)."""

    # intervals averaged before they fold into one (the reference's 20)
    WINDOW = 20

    def __init__(self):
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
            if len(self.times) >= self.WINDOW:
                self.times = [sum(self.times) / len(self.times)]
        self._last = now
        return dt

    def restart(self) -> None:
        """Start the next interval now, leaving out the time since the last
        tick (a save or a validation)."""
        self._last = time.perf_counter()

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0


@dataclasses.dataclass
class RunRecord:
    """What a training loop ran, by step number: each step's losses, the
    host seconds since the step before (``StepTimer``), each save's and each
    validation's seconds and results, and the logger's backend."""

    backend: str
    steps: Dict[int, Dict[str, float]] = dataclasses.field(default_factory=dict)
    seconds: Dict[int, float] = dataclasses.field(default_factory=dict)
    saves: Dict[int, float] = dataclasses.field(default_factory=dict)
    validations: Dict[int, Dict[str, float]] = dataclasses.field(default_factory=dict)
