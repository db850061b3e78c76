"""The port's three benches (``infer/train_bench.py``, ``rtf_bench.py``,
``serve_bench.py``) on the CPU with the tiny demo configs: their rows carry
the JAX benches' keys (listed here from the JAX package's
``infer/*_bench.py``), plus ``device``; ``--prng`` other than its default
raises, naming the reason; without a card and without ``--device cpu``
each raises.  No time is checked: a CPU time says nothing of the card."""

import os

import pytest

from tests._torch_parallel_worker import torch_one_thread  # noqa: F401 (a fixture)
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.infer import rtf_bench, serve_bench, train_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2V_TINY = os.path.join(REPO, "data", "demo", "text2vec_tiny.json")
V2W_TINY = os.path.join(REPO, "data", "demo", "vec2wav_tiny.json")

# the JAX benches' row keys (wavthruvec_pytorch_tpu/infer/*_bench.py)
JAX_T2V_KEYS = {"stage", "batch", "text_pad", "frame_pad", "dtype", "remat", "flash",
                "dropout", "prng", "sec_per_step", "steps_per_sec"}
JAX_V2W_KEYS = {"stage", "batch", "frames", "dtype", "sec_per_step", "audio_sec_per_sec"}
JAX_RTF_KEYS = {"batch", "x_realtime", "utt_per_sec", "ms_per_batch"}
JAX_LEG_KEYS = {"speaker_ecapa", "t2v_with_cached_spk", "t2v_with_ecapa"}
JAX_SERVE_KEYS = {"batch", "e2e_ms_cached_spk", "e2e_ms_full", "utt_per_sec_cached",
                  "x_realtime_cached"}


def _tiny():
    return load_config(Text2VecConfig, T2V_TINY), load_config(Vec2WavConfig, V2W_TINY)


def test_train_bench_rows_and_remat():
    """``--stage t2v --remat`` from the command line's parser, the same row
    without remat, and the GAN's row: JAX's keys, device "cpu", no peak
    memory on the CPU; remat changes neither the batch nor the losses nor
    the gradients, the first step's or the last's, after the updates."""
    t2v, v2w = _tiny()
    remat, = train_bench.main(["--stage", "t2v", "--B", "2", "--T", "64", "--remat",
                               "--t2v_config", T2V_TINY, "--device", "cpu"])
    plain = train_bench.bench_t2v(B=2, T=64, cfg=t2v, device="cpu", iters=train_bench.ITERS)
    for row in (plain, remat):
        assert JAX_T2V_KEYS <= set(row) and row["device"] == "cpu"
        assert row["peak_mem_gib"] is None and row["sec_per_step"] > 0
    assert (plain["remat"], remat["remat"]) == (False, True)
    for key in ("first_total_loss", "last_total_loss", "last_grad_norm"):
        assert plain[key] == remat[key], key
    assert plain["last_total_loss"] != plain["first_total_loss"]
    gan = train_bench.bench_v2w(B=2, T=8, cfg=v2w, device="cpu", iters=1)
    assert JAX_V2W_KEYS <= set(gan) and gan["device"] == "cpu" and gan["audio_sec_per_sec"] > 0


def test_rtf_bench_rows():
    """From the command line's parser: a row a batch size."""
    rows = rtf_bench.main(["--batch-sizes", "1", "2", "--frames", "40", "--t2v_config", T2V_TINY,
                           "--v2w_config", V2W_TINY, "--device", "cpu"])
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == JAX_RTF_KEYS | {"device"} and r["device"] == "cpu"
        assert r["x_realtime"] == pytest.approx(r["utt_per_sec"] * 40 * 320 / 16000)


def test_serve_bench_rows():
    t2v, v2w = _tiny()
    out = serve_bench.run([1, 2], iters=2, t2v_cfg=t2v, v2w_cfg=v2w, device="cpu", n_frames=40)
    assert set(out["legs_b1_ms"]) == JAX_LEG_KEYS | {"vocoder"}
    assert [r["batch"] for r in out["batches"]] == [1, 2]
    for r in out["batches"]:
        assert set(r) == JAX_SERVE_KEYS | {"device"} and r["device"] == "cpu"


@pytest.mark.parametrize("bench", ["train_bench", "rtf_bench", "serve_bench"])
def test_benches_refuse_without_card_or_with_another_prng(bench):
    """Without ``--device cpu`` a bench asks for the card, and this machine
    has none: it raises, it does not fall back.  ``--prng rbg`` raises
    before anything runs, naming PyTorch's generator."""
    t2v, v2w = _tiny()
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        if bench == "train_bench":
            train_bench.bench_t2v(B=2, N=16, T=64, cfg=t2v)
        elif bench == "rtf_bench":
            rtf_bench.run((1,), n_frames=8, iters=1, t2v_cfg=t2v, v2w_cfg=v2w)
        else:
            serve_bench.run([1], iters=1, t2v_cfg=t2v, v2w_cfg=v2w, n_frames=8)
    if bench == "train_bench":
        with pytest.raises(ValueError, match="PyTorch's generator"):
            train_bench.main(["--stage", "t2v", "--prng", "rbg", "--device", "cpu"])
