"""LAMB with the semantics of the JAX package's ``reference_lamb``
(train/lamb.py:41-98), which is ``torch_optimizer.Lamb`` as the reference
trains with it (text2vec/train.py:252-256):

* no Adam bias correction;
* ``adam_step = m / (sqrt(v) + eps) + weight_decay * p``: eps after the
  sqrt, weight decay folded in before the trust ratio;
* per tensor, ``trust = clamp(||p||, 0, CLAMP_VALUE) / ||adam_step||``
  (``CLAMP_VALUE`` = 10, torch_optimizer's default), or 1 when either norm
  is 0;
* ``p -= lr * trust * adam_step``.

Parameters without a gradient (``requires_grad=False`` ones are not handed
to it at all) are left alone.  The update runs as multi-tensor
``torch._foreach_*`` calls, so its launch count does not grow with the
number of tensors.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

CLAMP_VALUE = 10.0


class Lamb(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["exp_avg"] = torch.zeros_like(p)
                    self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            denom = torch._foreach_sqrt(v)
            torch._foreach_add_(denom, group["eps"])
            steps = torch._foreach_div(m, denom)
            torch._foreach_add_(steps, torch._foreach_mul(params, group["weight_decay"]))
            w_norm = torch.stack(torch._foreach_norm(params)).clamp(0.0, CLAMP_VALUE)
            a_norm = torch.stack(torch._foreach_norm(steps))
            trust = torch.where((w_norm == 0) | (a_norm == 0), torch.ones_like(w_norm),
                                w_norm / a_norm)
            torch._foreach_mul_(steps, list((-group["lr"] * trust).unbind()))
            torch._foreach_add_(params, steps)
