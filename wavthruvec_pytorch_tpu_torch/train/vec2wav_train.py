"""One Vec2Wav GAN training step (JAX package: train/vec2wav_train.py
``train_step``; reference: vec2wav/train.py:57-296).

A step, in the JAX package's order:

1. noise ~ N(0, I) [B, noise_dim] from the trainer's ``torch.Generator``,
   unless the caller passes it;
2. y_hat = G(wv_feat, spk_emb, noise) in train mode: the Conditional
   BatchNorms normalise with the batch's statistics and move their running
   ones, and their spectral norms take one power iteration;
3. the D step: MPD + MSD on (y, y_hat detached), the LSGAN loss, AdamW;
4. the G step against the updated discriminators: mel L1 x 45 + feature
   matching + adversarial, AdamW.  The MSD's spectral vectors advance again
   here (JAX: ``msd_spectral_1 -> _2``).

JAX runs the Generator twice from the same state, once for the D step's
input and once inside the G step's gradient; both runs give the same
waveform, batch statistics and spectral vectors.  Here it runs once and the
G step's backward reuses that graph: the same computation.  The G step's
backward reaches only the Generator's parameters, so the discriminators'
gradients stay those of the D step.

AdamW is ``torch.optim.AdamW`` with the reference's settings, the same
update as ``optax.adamw``: lr ``cfg.learning_rate``, betas
``(adam_b1, adam_b2)``, eps 1e-8, weight decay 0.01 (vec2wav/train.py:96-98).

The trainer builds its modules as the JAX package's ``init_state`` does
(train/vec2wav_train.py:80-91): with ``cfg.compute_dtype == "bfloat16"``
the Generator and both discriminators compute their convolutions in bf16
(``models/vec2wav.py``), their parameters, AdamW and its state staying f32;
the MSD takes the grouped repack with ``cfg.msd_tiled_conv``.  As in JAX, a
bf16 step's waveform, scores and feature maps are bf16, so its adversarial
and feature-matching losses are bf16 sums; the mel target and the mel loss
are f32 (``ops/stft.py`` computes in f32), and so is the G loss's total.

In a process group (``parallel/mesh.py``) each rank steps on its local
batch and the step computes what one process computes on the global batch
(JAX: ``make_train_step(mesh=...)``): the Conditional BatchNorms take global
statistics, the D and the G gradients are averaged over the ranks
(``all_reduce_mean``) before each AdamW step, and the reported losses are
the ranks' means.  Every loss is a mean over a rank's batch, and the ranks'
batches have one shape, so the mean of the ranks' gradients is the global
batch's.  The spectral norms' power iteration reads only the weights, which
every rank holds alike, so each rank computes the same ``u``.  Explicit
all-reduces at these two points, not ``DistributedDataParallel``: DDP's
hooks would fire on every backward, the D step's pass through the detached
``y_hat`` and the G step's pass through the discriminators included.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.vec2wav import (
    Generator,
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_loss,
    generator_loss,
)
from wavthruvec_pytorch_tpu_torch.ops.stft import mel_spectrogram
from wavthruvec_pytorch_tpu_torch.parallel.mesh import (
    all_reduce_mean,
    mean_scalars,
    rank,
    world_size,
)

# the scalars a step reports, as the JAX package names them
SCALAR_KEYS = ("gen_loss_total", "disc_loss_total", "mel_loss", "mel_spec_error")


def make_optimizers(cfg: Vec2WavConfig, gen_params: Iterable[torch.nn.Parameter],
                    disc_params: Iterable[torch.nn.Parameter]):
    """(AdamW over the Generator, AdamW over both discriminators)."""
    def make(params):
        return torch.optim.AdamW(list(params), lr=cfg.learning_rate,
                                 betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8, weight_decay=0.01)

    return make(gen_params), make(disc_params)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch ExponentialLR: the loop sets lr0 * lr_decay ** epoch
    (vec2wav/train.py:104-105, 295-296)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def log_mel(cfg: Vec2WavConfig, audio: torch.Tensor) -> torch.Tensor:
    """[B, L, 1] -> the log-mel [B, frames, num_mels] of the mel loss."""
    return mel_spectrogram(audio[..., 0], cfg.n_fft, cfg.num_mels, cfg.sampling_rate,
                           cfg.hop_size, cfg.win_size, cfg.fmin,
                           cfg.fmax_for_loss).transpose(1, 2)


class GANTrainer:
    """A Generator (``fused=False``, train mode), the two discriminators,
    their AdamW optimizers and the step counter.  ``step(batch)`` runs one
    training step on a batch from ``data.vocoder_data.pad_vocoder_batch``
    (or ``VocoderDeviceData.batch``) and returns the ``SCALAR_KEYS`` losses
    as 0-dim tensors on the device; ``generate``, ``d_step`` and ``g_step``
    are its parts.  Runs on the card unless ``device="cpu"`` is passed;
    ``seed`` seeds the noise stream.  Modules passed in are used as they
    are; the ones it builds follow ``cfg.compute_dtype`` and
    ``cfg.msd_tiled_conv``."""

    def __init__(self, cfg: Vec2WavConfig, device=None, seed: int = 0,
                 generator: Optional[Generator] = None,
                 mpd: Optional[MultiPeriodDiscriminator] = None,
                 msd: Optional[MultiScaleDiscriminator] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.gen = (generator or Generator(cfg, device=self.device, fused=False,
                                           dtype=dtype)).train()
        if self.gen.fused:
            raise ValueError("GANTrainer trains Generator(fused=False); the fused Generator "
                             "serves only")
        self.mpd = (mpd or MultiPeriodDiscriminator(cfg, cfg.disc_pair_batched, dtype=dtype,
                                                    device=self.device)).train()
        self.msd = (msd or MultiScaleDiscriminator(cfg.disc_pair_batched,
                                                   tiled_conv=cfg.msd_tiled_conv, dtype=dtype,
                                                   device=self.device)).train()
        self.gen_params = list(self.gen.parameters())
        self.disc_params = list(itertools.chain(self.mpd.parameters(), self.msd.parameters()))
        self.opt_g, self.opt_d = make_optimizers(cfg, self.gen_params, self.disc_params)
        self.noise_rng = torch.Generator(device=self.device).manual_seed(seed)
        self.step_count = 0

    def set_learning_rate(self, lr: float) -> None:
        set_learning_rate(self.opt_g, lr)
        set_learning_rate(self.opt_d, lr)

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """The step's arrays of a batch (numpy arrays or tensors) as f32 and
        int64 tensors on the trainer's device; a tensor already there is
        used as it is."""
        keys = ("wv_feat", "spk_emb", "audio",
                "mel_frames" if self.cfg.device_mel_target else "mel_loss")
        out = {}
        for k in keys:
            v = batch[k]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.array(v))
            out[k] = v.to(self.device, torch.float32 if v.is_floating_point() else torch.int64)
        return out

    def mel_target(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch's ``mel_loss``, or with ``device_mel_target`` the log-mel
        of its audio computed here, 0 past each item's ``mel_frames`` as the
        host path pads it (JAX: vec2wav_train.py:157-167)."""
        if not self.cfg.device_mel_target:
            return batch["mel_loss"]
        with torch.no_grad():
            mel = log_mel(self.cfg, batch["audio"])
            frame = torch.arange(mel.shape[1], device=mel.device)
            return mel * (frame[None] < batch["mel_frames"][:, None])[..., None]

    def generate(self, batch: Dict[str, torch.Tensor],
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The Generator's forward in train mode: y_hat [B, L, 1].  In a
        process group each rank draws the global batch's noise and takes its
        own rows of it, as one process stepping the global batch would."""
        if noise is None:
            B, n = batch["wv_feat"].shape[0], world_size()
            noise = torch.randn((B * n, self.cfg.noise_dim), generator=self.noise_rng,
                                device=self.device)[rank() * B:(rank() + 1) * B]
        return self.gen(batch["wv_feat"], batch["spk_emb"], noise)

    def d_step(self, batch: Dict[str, torch.Tensor], y_hat: torch.Tensor) -> torch.Tensor:
        """MPD + MSD on (y, y_hat detached), the LSGAN loss, its backward and
        the AdamW update of both discriminators.  Returns the loss."""
        y, y_hat = batch["audio"], y_hat.detach()
        y_df_r, y_df_g, _, _ = self.mpd(y, y_hat)
        y_ds_r, y_ds_g, _, _ = self.msd(y, y_hat)
        loss = discriminator_loss(y_df_r, y_df_g)[0] + discriminator_loss(y_ds_r, y_ds_g)[0]
        self.opt_d.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_mean([p.grad for p in self.disc_params if p.grad is not None])
        self.opt_d.step()
        return loss.detach()

    def g_step(self, batch: Dict[str, torch.Tensor], y_hat: torch.Tensor,
               y_mel: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The G loss against the (updated) discriminators, its backward into
        the Generator's parameters only, and the Generator's AdamW update."""
        y_g_mel = log_mel(self.cfg, y_hat)  # [B, frames, M]
        y_mel = y_mel[:, :y_g_mel.shape[1]]
        mel_error = torch.mean(torch.abs(y_mel - y_g_mel))
        loss_mel = mel_error * 45.0
        y = batch["audio"]
        _, y_df_g, fmap_f_r, fmap_f_g = self.mpd(y, y_hat)
        _, y_ds_g, fmap_s_r, fmap_s_g = self.msd(y, y_hat)
        total = (generator_loss(y_ds_g)[0] + generator_loss(y_df_g)[0]
                 + feature_loss(fmap_s_r, fmap_s_g) + feature_loss(fmap_f_r, fmap_f_g) + loss_mel)
        self.opt_g.zero_grad(set_to_none=True)
        total.backward(inputs=self.gen_params)
        all_reduce_mean([p.grad for p in self.gen_params if p.grad is not None])
        self.opt_g.step()
        return {"gen_loss_total": total.detach(), "mel_loss": loss_mel.detach(),
                "mel_spec_error": mel_error.detach()}

    def state_dict(self) -> Dict[str, object]:
        """The three modules' state dicts (the Conditional BatchNorms'
        running statistics and every spectral norm's ``u``/``v`` buffers
        included), both AdamW states (keyed by the index of each of
        ``gen_params`` and ``disc_params``) and the step count."""
        return {"generator": self.gen.state_dict(), "mpd": self.mpd.state_dict(),
                "msd": self.msd.state_dict(), "optim_g": self.opt_g.state_dict(),
                "optim_d": self.opt_d.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Load what ``state_dict`` returned (tensors on any device)."""
        for name, module in (("generator", self.gen), ("mpd", self.mpd), ("msd", self.msd)):
            module.load_state_dict(state[name], strict=True)
        self.opt_g.load_state_dict(state["optim_g"])
        self.opt_d.load_state_dict(state["optim_d"])
        self.step_count = int(state["step_count"])

    def step(self, batch, noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One D/G step on a batch (see ``to_device``); ``noise``
        [B, noise_dim] replaces the trainer's own draw (to reproduce a JAX
        step)."""
        dev = self.to_device(batch)
        y_mel = self.mel_target(dev)
        y_hat = self.generate(dev, None if noise is None else noise.to(self.device))
        disc = self.d_step(dev, y_hat)
        metrics = {"disc_loss_total": disc, **self.g_step(dev, y_hat, y_mel)}
        self.step_count += 1
        return mean_scalars(metrics)
