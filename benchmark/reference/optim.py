"""The two optimizers of the reference, written out element by element.

* LAMB as ``torch_optimizer.Lamb``, which the published Text2Vec trains
  with: no bias correction, ``eps`` after the square root, weight decay
  added to the Adam step, a per-tensor trust ratio ``min(||p||, 10) /
  ||step||`` (1 where either norm is 0);
* AdamW as ``torch.optim.AdamW``, which the published Vec2Wav trains with:
  decoupled weight decay ``p *= 1 - lr * wd``, bias-corrected moments.

Each takes and returns plain dicts of tensors; a parameter whose gradient
is None is left alone.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

LAMB_CLAMP = 10.0


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, Optional[torch.Tensor]], max_norm: float) -> None:
    """Scale every gradient by max_norm / n where the global norm n >= max_norm."""
    gs = [g for g in grads.values() if g is not None]
    n = torch.sqrt(sum(torch.sum(g * g) for g in gs))
    if float(n) >= max_norm:
        for k, g in grads.items():
            if g is not None:
                grads[k] = g / n * max_norm


@torch.no_grad()
def lamb_step(params, grads, state, lr, b1, b2, eps, wd) -> None:
    for k, g in grads.items():
        if g is None:
            continue
        p = params[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        state[k] = (m, v)
        step = m / (torch.sqrt(v) + eps) + wd * p
        w_norm = torch.linalg.vector_norm(p).clamp(0.0, LAMB_CLAMP)
        s_norm = torch.linalg.vector_norm(step)
        trust = torch.where((w_norm == 0) | (s_norm == 0), torch.ones_like(w_norm), w_norm / s_norm)
        p.sub_(lr * trust * step)


@torch.no_grad()
def adamw_step(params, grads, state, t: int, lr, b1, b2, eps, wd) -> None:
    """``t`` is the 1-based step number."""
    for k, g in grads.items():
        if g is None:
            continue
        p = params[k]
        m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
        p.mul_(1.0 - lr * wd)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        state[k] = (m, v)
        denom = torch.sqrt(v) / math.sqrt(1.0 - b2 ** t) + eps
        p.sub_(lr / (1.0 - b1 ** t) * m / denom)
