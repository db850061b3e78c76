"""The numbers that decide ``correct``, each computed the same way for the
program and for the control (the reference in a lower precision), against
the reference in the configuration's own precision.

Training (a step's losses, the first gradient, the change after three
steps), each by the worst leaf or step:

* ``loss_gap``: |loss - reference loss| / |reference loss| (``loss1_gap``:
  of step 1 alone);
* ``grad_gap``: the gap between the program's and the reference's norm of a
  leaf's first gradient, over the larger of the reference's norm of that
  leaf and of the median leaf;
* ``change_gap``: the same for the norm of a leaf's change over the first
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone);
* ``grad_gap_med``, ``change_gap_med``: the median leaf's gap, where the
  worst leaf's is noise (see PERF.md);
* ``mas_gap`` (Text2Vec): the reference follows the program's alignment
  search at each step, as it follows a served answer's durations, and this
  is how far, in nats, that path's log-likelihood lies below the best
  path's under the reference's soft alignment, or infinite where the
  program's path is no width-1 monotonic alignment of the item's lengths
  (a search that writes nothing, or skips or repeats a text, would
  otherwise pass, followed by the reference).  A search is discrete: any
  rounding flips its near-ties, and an unfollowed flip would move every
  later number by more than the precision does.

Serving (each checked request's answer, judged by what it says):

* ``dur_gap_frames``: how far, in frames, the durations the answer implies
  lie outside the reference's rounding of its duration predictor; where
  the answer's length differs from the reference's rounding, the tokens
  nearest a rounding boundary are taken to have rounded the other way;
* ``pcm_gap_lsb``: how far, in steps of 16-bit PCM, the reference waveform
  (on those durations) lies outside the interval that truncates to the
  answer's sample.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

ZERO_GRAD_SHARE = 1e-3


def _median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [[...] per step], "grad": {leaf:
    norm}, "change": {leaf: norm}}.  ``worst`` names the leaves (and step)
    behind each reading, for the run's log."""
    loss = [(abs(p - r) / max(abs(r), 1e-30), f"step {s + 1} loss {j}")
            for s, (ps, rs) in enumerate(zip(prog["losses"], ref["losses"]))
            for j, (p, r) in enumerate(zip(ps, rs))]
    g_ref = ref["grad"]
    g_med = _median(g_ref.values())
    grad = [(abs(prog["grad"].get(k, 0.0) - v) / max(v, g_med, 1e-30), k)
            for k, v in g_ref.items()]
    moved = [k for k, v in g_ref.items() if v >= ZERO_GRAD_SHARE * g_med]
    c_med = _median(ref["change"][k] for k in moved)
    change = [(abs(prog["change"].get(k, 0.0) - ref["change"][k])
               / max(ref["change"][k], c_med, 1e-30), k) for k in moved]
    worst = {n: sorted(v, reverse=True)[:3] for n, v in
             (("loss_gap", loss), ("grad_gap", grad), ("change_gap", change))}
    out = {"loss_gap": max(loss)[0], "loss1_gap": max(v for v, n in loss if n.startswith("step 1 ")),
           "grad_gap": max(grad)[0], "grad_gap_med": _median(v for v, _ in grad),
           "change_gap": max(change)[0], "change_gap_med": _median(v for v, _ in change),
           "worst": {n: [[name, val] for val, name in v] for n, v in worst.items()}}
    if "mas_gap" in ref:
        out["mas_gap"] = ref["mas_gap"]
    return out


def reconcile_durations(dp: torch.Tensor, durations: torch.Tensor, valid: torch.Tensor,
                        frames: int, max_frames: int) -> Tuple[torch.Tensor, float]:
    """The durations an answer of ``frames`` frames implies, from the
    reference's ``dp`` [N] and its rounding ``durations`` [N] over the
    ``valid`` tokens, and the gap: 0 where the reference's rounding gives
    that length, else the distance to the rounding boundary of each token
    taken to round the other way (the largest), inf past three tokens."""
    total = int(durations.sum())
    if min(total, max_frames) == frames:
        return durations, 0.0
    need = frames - total
    if abs(need) > 3 or (frames == max_frames and total > max_frames):
        return durations, math.inf
    frac = (dp + 0.5) - torch.floor(dp + 0.5)
    margin = (1.0 - frac) if need > 0 else frac
    margin = torch.where(valid, margin, torch.full_like(margin, math.inf))
    order = torch.argsort(margin)[:abs(need)]
    out = durations.clone()
    out[order] += 1 if need > 0 else -1
    return out, float(margin[order].max())


def pcm_gap(pcm: np.ndarray, ref_wav: torch.Tensor) -> float:
    """Largest distance, in PCM steps, of ``ref_wav * 32767`` (clipped to
    [-1, 1] first) from the interval that truncates toward zero to the
    answer's int16 sample ``pcm``."""
    x = ref_wav.clamp(-1.0, 1.0).double().cpu().numpy() * 32767.0
    p = pcm.astype(np.float64)
    lo = np.where(p > 0, p, np.where(p < 0, p - 1.0, -1.0))
    hi = np.where(p < 0, p, np.where(p > 0, p + 1.0, 1.0))
    gap = np.maximum(np.maximum(lo - x, x - hi), 0.0)
    return float(gap.max()) if gap.size else 0.0


def checks_line(values: Dict[str, float], limits: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, value, limit) of every number the limits name."""
    missing = [k for k in limits if k not in values]
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    return [(k, float(values[k]), float(limits[k])) for k in limits]


def passed(checks: List[Tuple[str, float, float]], failed: int) -> bool:
    return bool(checks) and failed == 0 and all(v <= lim for _, v, lim in checks)


def leaf_norms(tensors: Dict[str, Optional[torch.Tensor]]) -> Dict[str, float]:
    return {k: (0.0 if t is None else float(torch.linalg.vector_norm(t.detach().float())))
            for k, t in tensors.items()}
