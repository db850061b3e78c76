"""Length-regulator expansion as a gather (JAX package:
ops/length_regulator.py ``expand_by_durations``).

Frame t is assigned token j iff ``cumsum(d)[j-1] <= t < cumsum(d)[j]`` —
the reference's ``create_alignment`` (text2vec/module.py:45-53).  Frames at
or beyond ``sum(durations)`` are zero; the returned total is NOT clamped to
``max_frames``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def expand_by_durations(
    x: torch.Tensor, durations: torch.Tensor, max_frames: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, N, C] token states, durations [B, N] int ->
    ([B, max_frames, C] expanded states, [B] total frame counts)."""
    durations = durations.to(torch.int64)
    B, N, C = x.shape
    ends = torch.cumsum(durations, dim=1)  # [B, N]
    total = ends[:, -1]
    t = torch.arange(max_frames, device=x.device)[None, :].expand(B, max_frames)
    # token index for each frame: number of ends <= t
    idx = torch.searchsorted(ends, t.contiguous(), right=True)  # [B, T]
    valid = t < total[:, None]
    idx = idx.clamp(max=N - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(B, max_frames, C))
    out = torch.where(valid[:, :, None], out, out.new_zeros(()))
    return out, total
