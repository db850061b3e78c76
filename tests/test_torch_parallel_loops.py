"""Both training loops of the port as two-rank jobs over gloo on the CPU:
``text2vec_loop.main`` and ``vec2wav_loop.main`` on the tiny demo configs,
2 steps each, each rank staging its share of the corpus in a device cache
(``device_resident_data``, on the CPU here).

The ranks run in spawned processes (``tests/_torch_parallel_worker.py``;
every wait has a deadline).  The one-process side runs here: the same
seeded trainer stepping the global batches, each the two ranks' batches
concatenated, rebuilt from each rank's share of the file list, loader and
cache.  Losses rtol 1e-5 (f32, the order of sums the only difference).
Dropout is 0: the ranks draw dropout from their own streams.
"""

import dataclasses
import os

import numpy as np
import torch

from tests.torch_threads import share_cores  # noqa: F401  (autouse: the xdist worker's cores)
from tests import _torch_parallel_worker as worker
from tests._torch_parallel_worker import torch_one_thread  # noqa: F401 (a fixture)
from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, load_config
from wavthruvec_pytorch_tpu_torch.data.dataset import BucketedLoader, load_buffer
from wavthruvec_pytorch_tpu_torch.data.device_cache import DeviceResidentData
from wavthruvec_pytorch_tpu_torch.data.vocoder_data import (
    VocoderDataset,
    VocoderLoader,
    get_dataset_filelist,
)
from wavthruvec_pytorch_tpu_torch.data.vocoder_device_cache import VocoderDeviceData
from wavthruvec_pytorch_tpu_torch.parallel.launch import run_local
from wavthruvec_pytorch_tpu_torch.parallel.mesh import process_shard
from wavthruvec_pytorch_tpu_torch.text import TextFrontend
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import SCALAR_KEYS as T2V_KEYS
from wavthruvec_pytorch_tpu_torch.train.text2vec_train import Text2VecTrainer
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import SCALAR_KEYS as GAN_KEYS
from wavthruvec_pytorch_tpu_torch.train.vec2wav_train import GANTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
WORLD = 2


def _concat(batches):
    return {k: torch.cat([torch.as_tensor(np.asarray(b[k])) for b in batches])
            for k in batches[0] if k not in ("audiopaths", "filenames")}


def _t2v_one_process(cfg):
    """The global batches of the two-rank job, stepped by one trainer."""
    frontend = TextFrontend.from_vocab_file(cfg.vocab_path)
    cfg = dataclasses.replace(cfg, vocab_size=frontend.vocab_size)
    full = load_buffer(list(cfg.train_list), cfg, frontend)
    per_rank = []
    for r in range(WORLD):
        shard = process_shard(full, r, WORLD)
        loader = BucketedLoader(shard, cfg, seed=0, batch_size=cfg.batch_size // WORLD,
                                pad_to_max=True)
        cache = DeviceResidentData(shard, cfg, device="cpu")
        per_rank.append([cache.batch(idx, pad_to_max=True) for idx in loader.epoch_indices()])
    torch.manual_seed(0)
    trainer = Text2VecTrainer(cfg, device="cpu")
    out = []
    for k in range(STEPS):
        metrics = trainer.step(_concat([b[k] for b in per_rank]))
        out.append([metrics[key].item() for key in T2V_KEYS])
    return out


def _gan_one_process(cfg):
    files, _ = get_dataset_filelist(cfg.input_training_file, cfg.input_validation_file)
    per_rank = []
    for r in range(WORLD):
        ds = VocoderDataset(process_shard(files, r, WORLD), cfg)
        loader = VocoderLoader(ds, cfg.batch_size // WORLD, seed=cfg.seed, num_workers=0)
        cache = VocoderDeviceData(ds, cfg, device="cpu")
        per_rank.append([cache.batch(idx) for idx in loader.epoch_indices()])
    torch.manual_seed(cfg.seed)
    trainer = GANTrainer(cfg, device="cpu", seed=cfg.seed)
    out = []
    for k in range(STEPS):
        metrics = trainer.step(_concat([b[k] for b in per_rank]))
        out.append([metrics[key].item() for key in GAN_KEYS])
    return out


def test_two_rank_loops_match_one_process(tmp_path):
    """Two ranks, 2 steps of each loop: every rank reports the global
    batch's losses, equal (rtol 1e-5) to one process stepping the
    concatenated batches; only rank 0 wrote files (``config.json``, the
    checkpoints, the logs), one set of them, and every rank took part in
    each save."""
    cwd = os.getcwd()
    os.chdir(REPO)  # the configs' paths are relative to the repository root
    try:
        t2v = dataclasses.replace(
            load_config(Text2VecConfig, "data/demo/text2vec_tiny.json"),
            run_path=str(tmp_path / "t2v"), batch_size=4, dropout=0.0, save_step=1,
            device_resident_data=True)
        gan = dataclasses.replace(
            load_config(Vec2WavConfig, "data/demo/vec2wav_tiny.json"),
            run_path=str(tmp_path / "gan"), split=True, device_mel_target=True,
            device_resident_data=True)
        common = ["--max_steps", str(STEPS), "--device", "cpu"]
        jobs = [("t2v", common + ["--seed", "0"], t2v, REPO),
                ("v2w", common + ["--num_workers", "0", "--stdout_interval", "1"], gan, REPO)]
        ranks = run_local(worker.train_loops, WORLD, (jobs,), timeout=300.0)
        want = {"t2v": _t2v_one_process(t2v), "v2w": _gan_one_process(gan)}
    finally:
        os.chdir(cwd)
    for i, (stage, keys) in enumerate((("t2v", T2V_KEYS), ("v2w", GAN_KEYS))):
        r0, r1 = (r[i] for r in ranks)
        first = 1 if stage == "t2v" else 0  # the GAN loop numbers its steps from 0
        for r in (r0, r1):
            got = [[r["steps"][first + k][key] for key in keys] for k in range(STEPS)]
            print(stage, "ranks", got, "one process", want[stage])
            np.testing.assert_allclose(got, want[stage], rtol=1e-5, err_msg=stage)
        assert r0["saves"] == r1["saves"] and r0["saves"]
        assert r1["written"] == []
        assert "config.json" in r0["written"] and "logger" in r0["written"]
    assert sorted(os.listdir(tmp_path / "t2v" / t2v.log_seed / "model_new")) == [
        "checkpoint_1.pth.tar", "checkpoint_2.pth.tar"]
    assert sorted(os.listdir(tmp_path / "gan" / gan.log_seed / "model_new")) == [
        "do_00000001", "g_00000001"]
    log = tmp_path / "t2v" / t2v.log_seed / "tb_logs" / "scalars.jsonl"
    assert len(log.read_text().splitlines()) == STEPS * len(T2V_KEYS)
