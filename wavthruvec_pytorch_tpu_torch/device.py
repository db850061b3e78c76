"""Device rule of the port: everything runs on the card unless the caller
asks for the CPU.  There is no silent fallback: without a GPU, a call that
did not pass ``device="cpu"`` raises."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "wavthruvec_pytorch_tpu_torch runs on an NVIDIA GPU by default and "
            "none is visible to PyTorch; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU."
        )
    return dev
