"""A run with its timed path broken underneath the harness comes out not
correct: for each fault a cell can have, the harness runs the rest of a
run (on the CPU at a tiny size, the look for a card skipped) and the check
fails; the same run unbroken passes.  The limits are the cells' own where
the tiny size reads within them, else ones set the same way at that size."""

import time

import pytest
import torch

import tiny
from wtvbench import runner

SERVE = ("serve_c16", "serve_closed_c16")
T2V = ("t2v_train_b16", "t2v_train_b16_n64_t1024")
GAN = ("gan_train_b2", "gan_train_b2_t256")
# tiny-size limits: sound runs read ~1e-6 (serve), ~2e-3, 1e-2 and 0.6 (the
# CBHG's max pool and ECAPA at B = 4 under LAMB at lr 0.1), and ~1e-4 (GAN)
LIMITS = {SERVE: {"dur_gap_frames": 0.01, "pcm_gap_lsb": 4.0},
          T2V: {"loss_gap": 0.02, "grad_gap": 0.05, "change_gap": 0.95, "mas_gap": 0.1},
          GAN: {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}}


def _run(cell, fault=None, seed=1234567):
    c = tiny.cell(*cell, LIMITS[cell])
    return runner.run_cell(c, seed, 0.5, False, "cpu", time.time(), fault)


@pytest.mark.parametrize("cell,fault", [(SERVE, "answer_altered"), (T2V, "state_unchanged"),
                                        (T2V, "half_batch"), (GAN, "state_unchanged"),
                                        (GAN, "half_batch")])
def test_fault_is_not_correct(cell, fault):
    assert _run(cell, fault)["correct"] is False


def _mas_nothing(attn, in_lens, out_lens):
    """An alignment kernel that writes nothing."""
    return torch.zeros_like(attn, dtype=torch.float32)


def _mas_skip(attn, in_lens, out_lens):
    """The search's path with text 1 skipped: its frames go to text 0."""
    from wavthruvec_pytorch_tpu_torch.ops.mas import mas_width1_plain

    hard = mas_width1_plain(attn, in_lens, out_lens)
    hard[:, :, 0] += hard[:, :, 1]
    hard[:, :, 1] = 0.0
    return hard


def _mas_double(attn, in_lens, out_lens):
    """The search's path with a second text in its first frame."""
    from wavthruvec_pytorch_tpu_torch.ops.mas import mas_width1_plain

    hard = mas_width1_plain(attn, in_lens, out_lens)
    hard[:, 0, 1] = 1.0
    return hard


@pytest.mark.parametrize("mas", [_mas_nothing, _mas_skip, _mas_double])
def test_alignment_altered_is_not_correct(monkeypatch, mas):
    """A broken alignment search: the reference follows the program's path,
    so only the path's own check can catch it."""
    from wavthruvec_pytorch_tpu_torch.models import text2vec

    monkeypatch.setattr(text2vec, "mas_width1", mas)
    r = _run(T2V)
    assert r["correct"] is False
    assert r["checks"]["mas_gap"]["value"] == "inf"


@pytest.mark.parametrize("cell", [SERVE, T2V, GAN])
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] is True, r["checks"]
