"""Frozen dataclass configs for the PyTorch port.

The port keeps its own copy of the two model configs of the JAX package
(``wavthruvec_pytorch_tpu/config.py``), field for field, so that the same
JSON config files (``data/demo/*.json``) load into both packages.  Fields
that only select a JAX implementation keep their names for file
compatibility:

* ``dropout_prng_impl`` selects nothing here: it names the JAX PRNG
  (threefry or rbg) that draws dropout keys, and the port draws from
  PyTorch's generator whatever it says;
* ``MeshConfig`` names JAX's data axis; the port's data parallelism is one
  process per card (``parallel/mesh.py``), and its world size is the
  launcher's, so ``n_data`` selects nothing;
* ``Text2VecConfig.flash_attention=True`` and ``compute_dtype="bfloat16"``
  are ported (the trainer computes in bf16, serving in f32, as in the JAX
  package), and so are ``attn_use_partial_padding=True``, windowed GAN
  training (``Vec2WavConfig.split=True``), ``device_resident_data=True`` in
  both loops, ``msd_tiled_conv``, ``Vec2WavConfig.compute_dtype=
  "bfloat16"`` (the bf16 GAN step; serving builds the f32 Generator for it,
  as the JAX package does, and bf16 serving goes through
  ``make_serving_generator``) and ``Text2VecConfig.input_wav=True`` (ECAPA
  on raw waveforms through its fbank front end).  ``flash_attention=True``
  takes every head dim, as JAX's flash branch does.

``gru_impl`` selects the CBHG BiGRU's numerics as it does in the JAX
package (``ops/gru.py`` ``gru_numerics``): ``"scan"``, the default, computes
the recurrence in f32 (``h`` and ``w_hh`` unrounded, JAX's ``lax.scan``);
``"pallas"`` rounds ``h`` and ``w_hh`` to bf16 for the hidden matmul with
an f32 carry (JAX's Pallas kernel) where JAX's gate ``gru_pallas_supported``
admits the shape (H % 128 == 0, at H = 1024 a batch of at most 28), and
computes f32 elsewhere, as JAX falls back to its scan.  Each has its own
hand-written kernel on the card.

Each config names its run's directories as the JAX package's does:
``{run_path}/{log_seed}/`` holds ``model_new/`` (the checkpoints),
``tb_logs/`` (the scalars), ``logger/logger.txt`` and ``config.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Text2VecConfig:
    """Text2Vec model + training config (reference: text2vec/hparams.py)."""

    n_feat_dim: int = 1024

    betabinom_cache_path: str = "./data/align_prior"
    betabinom_scaling_factor: float = 1.0
    use_attn_prior_masking: bool = True

    spk_channel: int = 1024
    n_speaker_dim: int = 192
    n_speakers: int = 200
    input_wav: bool = False

    max_seq_len: int = 3000
    encoder_dim: int = 256
    encoder_n_layer: int = 4
    encoder_head: int = 2
    encoder_conv1d_filter_size: int = 1024
    decoder_dim: int = 256
    decoder_n_layer: int = 4
    decoder_head: int = 2
    decoder_conv1d_filter_size: int = 1024
    fft_conv1d_kernel: Tuple[int, int] = (9, 1)
    fft_conv1d_padding: Tuple[int, int] = (4, 0)
    duration_predictor_filter_size: int = 256
    duration_predictor_kernel_size: int = 3
    dropout: float = 0.1

    vocab_size: int = 4285
    vocab_path: str = "./data/vocab.txt"

    run_path: str = "./run"
    log_seed: str = "30_30_spk_4fft"
    feat_ground_truth: str = "/data_mnt/aishell3/w2v_feat/"

    train_list: Tuple[str, ...] = ("./data/enc_train_full.txt",)
    val_list: Tuple[str, ...] = ("./data/enc_val_full.txt",)

    batch_size: int = 16
    epochs: int = 200
    n_warm_up_step: int = 4000
    batch_expand_size: int = 16
    save_step: int = 5000
    log_step: int = 1000
    val_step: int = 50000
    learning_rate: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.98
    epsilon: float = 1e-9
    weight_decay: float = 1e-6
    grad_clip_thresh: float = 1.0
    grad_clip_every: int = 10

    binarization_start_iter: int = 0
    kl_loss_start_iter: int = 0
    learn_alignments: bool = True
    binarization_loss_weight: float = 1.0
    use_multi_speaker_condition: bool = True
    use_speaker_emb_for_alignment: bool = True
    attn_use_partial_padding: bool = False

    compute_dtype: str = "float32"
    flash_attention: bool = False
    remat: bool = False
    dropout_prng_impl: str = "threefry2x32"
    gru_impl: str = "scan"
    text_buckets: Tuple[int, ...] = (32, 64, 128)
    frame_buckets: Tuple[int, ...] = (256, 512, 1024, 2048, 3000)
    device_resident_data: bool = False

    tensorboard_logs_path = property(lambda self: _run_dir(self, "tb_logs"))
    checkpoint_path = property(lambda self: _run_dir(self, "model_new"))
    logger_path = property(lambda self: _run_dir(self, "logger"))

    @property
    def encoder_output_dim(self) -> int:
        # the encoder concatenates the speaker embedding (reference: model.py:99)
        if self.use_multi_speaker_condition:
            return self.encoder_dim + self.n_speaker_dim
        return self.encoder_dim

    @property
    def decoder_model_dim(self) -> int:
        if self.use_multi_speaker_condition:
            return self.decoder_dim + self.n_speaker_dim
        return self.decoder_dim


@dataclasses.dataclass(frozen=True)
class Vec2WavConfig:
    """Vec2Wav (HiFi-GAN + conditional BN) config (reference: vec2wav/hparams.py)."""

    run_path: str = "./run_dec"
    log_seed: str = "30_30"
    feat_ground_truth: str = "/data_mnt/aishell3/w2v_feat/"
    train_wav_path: str = "/data_mnt/aishell3/"
    spk_emb_path: str = "/data_mnt/aishell3/spk_emb/"
    input_training_file: str = "./data/enc_train_full.txt"
    input_validation_file: str = "./data/enc_val_full.txt"

    save_step: int = 5000
    log_step: int = 1000
    val_step: int = 100000

    n_feat_dim: int = 1024
    spk_dim: int = 192
    noise_dim: int = 192

    # the reference compares the int 1 with the string '1' (models.py:84),
    # so ResBlock2 is what runs; the same int-vs-str selection is kept
    resblock: object = 1
    batch_size: int = 2
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234

    upsample_rates: Tuple[int, ...] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )

    periods: Tuple[int, ...] = (13, 17, 19)

    segment_size: int = 8192
    num_mels: int = 80
    num_wv_feat: int = 1024
    num_freq: int = 1025
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    sampling_rate: int = 16000
    fmin: float = 0.0
    fmax: Optional[float] = 8000.0
    fmax_for_loss: Optional[float] = None

    split: bool = False

    compute_dtype: str = "float32"
    frame_buckets: Tuple[int, ...] = (64, 128, 256, 512)
    disc_pair_batched: bool = True
    msd_tiled_conv: bool = True
    device_mel_target: bool = False
    device_resident_data: bool = False

    tensorboard_logs_path = property(lambda self: _run_dir(self, "tb_logs"))
    checkpoint_path = property(lambda self: _run_dir(self, "model_new"))
    logger_path = property(lambda self: _run_dir(self, "logger"))

    @property
    def total_upsample(self) -> int:
        out = 1
        for u in self.upsample_rates:
            out *= u
        return out

    @property
    def use_resblock1(self) -> bool:
        return self.resblock == "1"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The JAX package's data-parallel mesh layout (its ``config.py``), kept
    for file compatibility: ``n_data`` -1 means every visible device."""

    data_axis: str = "data"
    n_data: int = -1


def load_config(cls, path: str):
    """Read a JSON config into ``cls``; unknown keys are ignored and lists
    become tuples, as the JAX package's ``load_config`` does."""
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in raw.items() if k in field_names}
    for k, v in list(kwargs.items()):
        if isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
    return cls(**kwargs)


def _run_dir(cfg, name: str) -> str:
    return os.path.join(cfg.run_path, cfg.log_seed, name)


def save_config(cfg, path: str) -> None:
    """Snapshot a config as JSON into the run's directory (the reference
    copies its hparams.py there: text2vec/train.py:35-40,
    vec2wav/train.py:43-48); ``load_config`` reads it back."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


def parse_bool(value: str) -> bool:
    """A command-line switch's value: true/false, yes/no or 1/0 in any case.
    (The JAX loops' ``type=bool`` turned any non-empty string on, "False"
    included.)"""
    v = value.strip().lower()
    if v in ("true", "yes", "1"):
        return True
    if v in ("false", "no", "0"):
        return False
    raise ValueError(f"not a true/false value: {value!r}")


def check_ported(cfg) -> None:
    """Raise for a config flag whose JAX implementation is not ported yet,
    on every device, before any module is made: the models, trainers and
    loops call it.  Every flag of ``Text2VecConfig`` and ``Vec2WavConfig``
    is ported, flash attention at any head dim included, so it raises for
    none."""


def repo_path(*parts: str) -> str:
    """Absolute path of a file in the repository checkout."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), *parts)
