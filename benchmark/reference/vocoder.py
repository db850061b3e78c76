"""Plain Vec2Wav in f32: the HiFi-GAN Generator with Conditional BatchNorm
speaker and noise conditioning, the multi-period and multi-scale
discriminators, the LSGAN, feature-matching and mel losses (HiFi-GAN,
arXiv:2010.05646; WavThruVec, arXiv:2203.16930).

Parameters are a dict from the published implementation's state-dict names
(``p1an-lin-jung/WavThruVec_pytorch`` ``vec2wav/models.py``).  ``cfg`` is
the ``vec2wav`` section of a configuration file.  Kept from the published
code: ``resblock`` 1 against the string '1' selects ResBlock2, which uses
the first two dilations of each entry; the ResBlocks of a stage are
averaged; the activation before ``conv_post`` has slope 0.01; the
discriminators' widths are fixed whatever the configuration; the first MSD
scale is spectral-normed, the others weight-normed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .ops import Ops, batch_norm, spectral_weight, weight_norm

LRELU = 0.1
MPD_WIDTHS = (1, 32, 128, 512, 1024)
# (out channels, kernel, stride, groups, padding) of each MSD conv
MSD_SPECS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
             (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
             (1024, 5, 1, 1, 2))


def _padding(k: int, d: int = 1) -> int:
    return (k * d - d) // 2


def _check(cfg: dict) -> None:
    if cfg["resblock"] == "1":
        raise ValueError("the reference models ResBlock2 (resblock != '1') only")


def _wn(out: dict, pre: str, shape, g_shape, bias: int = 0) -> None:
    out[pre + "weight_g"] = g_shape
    out[pre + "weight_v"] = shape
    if bias:
        out[pre + "bias"] = (bias,)


def generator_shapes(cfg: dict) -> Dict[str, tuple]:
    _check(cfg)
    out: Dict[str, tuple] = {}
    ch0 = cfg["upsample_initial_channel"]
    _wn(out, "conv_pre.", (ch0, cfg["n_feat_dim"], 7), (ch0, 1, 1), ch0)
    n_k = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        c_in, ch = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        _wn(out, f"ups.{i}.", (c_in, ch, k), (c_in, 1, 1), ch)
        out[f"fcs.{i}.weight"] = (128, cfg["spk_dim"] + cfg["noise_dim"])
        out[f"fcs.{i}.bias"] = (128,)
        cb = f"cbns.{i}."
        for s in ("running_mean", "running_var"):
            out[cb + "batch_nrom." + s] = (ch,)
        out[cb + "batch_nrom.num_batches_tracked"] = ()
        out[cb + "layer.weight_orig"] = (2 * ch, 128)
        out[cb + "layer.bias"] = (2 * ch,)
        out[cb + "layer.weight_u"] = (2 * ch,)
        out[cb + "layer.weight_v"] = (128,)
        for j, rk in enumerate(cfg["resblock_kernel_sizes"]):
            for c in range(2):
                _wn(out, f"resblocks.{i * n_k + j}.convs.{c}.", (ch, ch, rk), (ch, 1, 1), ch)
    c_last = ch0 // 2 ** len(cfg["upsample_rates"])
    _wn(out, "conv_post.", (1, c_last, 7), (1, 1, 1), 1)
    return out


def mpd_shapes(cfg: dict) -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for d, _ in enumerate(cfg["periods"]):
        pre = f"discriminators.{d}."
        pairs = list(zip(MPD_WIDTHS, MPD_WIDTHS[1:])) + [(1024, 1024)]
        for j, (a, b) in enumerate(pairs):
            _wn(out, f"{pre}convs.{j}.", (b, a, 5, 1), (b, 1, 1, 1), b)
        _wn(out, pre + "conv_post.", (1, 1024, 3, 1), (1, 1, 1, 1), 1)
    return out


def msd_shapes(cfg: dict) -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for d in range(3):
        pre = f"discriminators.{d}."
        c_in = 1
        for j, (c_out, k, _, g, _) in enumerate(MSD_SPECS):
            _msd_conv(out, f"{pre}convs.{j}.", c_in, c_out, k, g, d == 0)
            c_in = c_out
        _msd_conv(out, pre + "conv_post.", 1024, 1, 3, 1, d == 0)
    return out


def _msd_conv(out, pre, c_in, c_out, k, g, spectral):
    if spectral:
        out[pre + "weight_orig"] = (c_out, c_in // g, k)
        out[pre + "bias"] = (c_out,)
        out[pre + "weight_u"] = (c_out,)
        out[pre + "weight_v"] = (c_in // g * k,)
    else:
        _wn(out, pre, (c_out, c_in // g, k), (c_out, 1, 1), c_out)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def _wconv(P, pre):
    return weight_norm(P[pre + "weight_v"], P[pre + "weight_g"])


def generator(P, latents, spk, noise, cfg: dict, train: bool, ops: Ops, state: dict,
              raw: bool = False, record: Optional[dict] = None):
    """latents [B, T, n_feat], spk [B, spk_dim], noise [B, noise_dim] ->
    waveform [B, T * prod(upsample_rates)] (``raw``: before the tanh).
    ``train`` normalises the Conditional BatchNorms on the batch (their
    statistics into ``record`` if given) and takes one power iteration of
    their spectral norms (new vectors into ``state``)."""
    z_in = torch.cat([spk, noise], dim=-1)
    x = ops.conv1d(latents.transpose(1, 2), _wconv(P, "conv_pre."), P["conv_pre.bias"],
                   padding=3)
    n_k = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"], cfg["upsample_kernel_sizes"])):
        x = ops.conv_transpose1d(F.leaky_relu(x, LRELU), _wconv(P, f"ups.{i}."),
                                 P[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        z = ops.linear(z_in, P[f"fcs.{i}.weight"], P[f"fcs.{i}.bias"])
        w = spectral_weight(P, f"cbns.{i}.layer.", train, state)
        gamma, beta = ops.linear(z, w, P[f"cbns.{i}.layer.bias"]).chunk(2, dim=-1)
        xn = batch_norm(x.transpose(1, 2), P, f"cbns.{i}.batch_nrom.", train, affine=False,
                        record=record)
        x = gamma[:, :, None] * xn.transpose(1, 2) + beta[:, :, None]
        acc = None
        for j, rk in enumerate(cfg["resblock_kernel_sizes"]):
            h = x
            dil = cfg["resblock_dilation_sizes"][j][:2]
            for c, d in enumerate(dil):
                pre = f"resblocks.{i * n_k + j}.convs.{c}."
                h = ops.conv1d(F.leaky_relu(h, LRELU), _wconv(P, pre), P[pre + "bias"],
                               padding=_padding(rk, d), dilation=d) + h
            acc = h if acc is None else acc + h
        x = acc / n_k
    x = ops.conv1d(F.leaky_relu(x, 0.01), _wconv(P, "conv_post."), P["conv_post.bias"], padding=3)
    return x[:, 0] if raw else torch.tanh(x)[:, 0]


# ---------------------------------------------------------------------------
# discriminators and losses
# ---------------------------------------------------------------------------

def mpd(P, wav, cfg: dict, ops: Ops):
    """wav [B, L] -> (scores, feature maps) per period."""
    outs = []
    for d, p in enumerate(cfg["periods"]):
        pre = f"discriminators.{d}."
        x = wav[:, None]
        L = x.shape[-1]
        if L % p:
            x = F.pad(x, (0, p - L % p), mode="reflect")
        x = x.reshape(x.shape[0], 1, -1, p)
        fmap = []
        for j in range(len(MPD_WIDTHS)):
            stride = (3, 1) if j < len(MPD_WIDTHS) - 1 else (1, 1)
            x = F.leaky_relu(ops.conv2d(x, _wconv(P, f"{pre}convs.{j}."),
                                        P[f"{pre}convs.{j}.bias"], stride=stride,
                                        padding=(2, 0)), LRELU)
            fmap.append(x)
        x = ops.conv2d(x, _wconv(P, pre + "conv_post."), P[pre + "conv_post.bias"],
                       padding=(1, 0))
        fmap.append(x)
        outs.append((x.flatten(1), fmap))
    return outs


def msd(P, wav, train: bool, ops: Ops, state: dict):
    """wav [B, L] -> (scores, feature maps) per scale; the first scale's
    spectral norms take one power iteration in train mode."""
    outs = []
    x0 = wav[:, None]
    for d in range(3):
        if d:
            x0 = F.avg_pool1d(x0, 4, 2, padding=2, count_include_pad=True)
        pre = f"discriminators.{d}."
        x, fmap = x0, []
        specs = list(MSD_SPECS) + [(1, 3, 1, 1, 1)]
        for j, (_, _, s, g, pad) in enumerate(specs):
            name = f"{pre}convs.{j}." if j < len(MSD_SPECS) else pre + "conv_post."
            w = spectral_weight(P, name, train, state) if d == 0 else _wconv(P, name)
            x = ops.conv1d(x, w, P[name + "bias"], stride=s, padding=pad, groups=g)
            if j < len(MSD_SPECS):
                x = F.leaky_relu(x, LRELU)
            fmap.append(x)
        outs.append((x.flatten(1), fmap))
    return outs


def pair(outs_fn, y, y_hat):
    """A discriminator over cat([y, y_hat]) split back into the real and the
    generated halves: (real scores, fake scores, real fmaps, fake fmaps)."""
    B = y.shape[0]
    outs = outs_fn(torch.cat([y, y_hat], dim=0))
    return ([o[:B] for o, _ in outs], [o[B:] for o, _ in outs],
            [[m[:B] for m in f] for _, f in outs], [[m[B:] for m in f] for _, f in outs])


def d_loss(real: List[torch.Tensor], fake: List[torch.Tensor]):
    return sum(torch.mean((1.0 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(real, fake))


def g_adv_loss(fake: List[torch.Tensor]):
    return sum(torch.mean((1.0 - g) ** 2) for g in fake)


def fm_loss(fr, fg):
    return 2.0 * sum(torch.mean(torch.abs(r - g)) for dr, dg in zip(fr, fg) for r, g in zip(dr, dg))


def slaney_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> np.ndarray:
    """librosa's slaney-scale, slaney-normalised mel filterbank [n_mels, n_fft/2 + 1]."""
    fmax = sr / 2.0 if fmax is None else float(fmax)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz)
                        / logstep, f / f_sp)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * f_sp)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))
    ramps = pts[:, None] - freqs[None]
    lower = -ramps[:-2] / np.diff(pts)[:-1, None]
    upper = ramps[2:] / np.diff(pts)[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """[B, L] -> [B, frames, num_mels]: reflect pad (n_fft - hop) / 2 a side,
    |STFT| (Hann window, no centring) with 1e-9 under the root, the mel
    basis, log of at least 1e-5."""
    n_fft, hop, win = cfg["n_fft"], cfg["hop_size"], cfg["win_size"]
    pad = (n_fft - hop) // 2
    y = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=win,
                      window=torch.hann_window(win, device=wav.device, dtype=wav.dtype), center=False,
                      return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    basis = torch.from_numpy(slaney_mel_basis(cfg["sampling_rate"], n_fft, cfg["num_mels"],
                                              cfg["fmin"], cfg["fmax_for_loss"])).to(wav.device, wav.dtype)
    return torch.log(torch.clamp(basis @ mag, min=1e-5)).transpose(1, 2)

