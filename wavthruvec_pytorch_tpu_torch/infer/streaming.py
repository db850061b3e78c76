"""Streaming (chunked) vocoder inference (JAX package: infer/streaming.py).

The latent sequence is vocoded in fixed-size chunks, each with enough
context on both sides to cover the Generator's receptive field, so a long
utterance synthesizes in O(chunk) memory and its first audio goes out while
later chunks are still computing (the time to first audio of a server).

Exactness: every Generator layer is pointwise, a "same"-padded conv, or a
stride-u transposed conv, all translation-invariant away from the sequence's
edges, and the CBN conditioning (speaker and noise) is per utterance, not per
position.  A window with ``context`` true frames on both sides of its chunk
therefore computes the chunk exactly.  The edges are different: the full
forward's per-layer zero padding is not the same as zero latents (biases and
CBN shifts make deeper layers' padding nonzero), so the first window starts
at frame 0 and the last one ends at frame T, each seeing the real edge.
Windows are ``chunk + context`` frames long at the edges and ``chunk +
2 context`` inside, and every window runs the serving Generator: the f32 one
launches the fused ResBlock2 kernel at those lengths.  On the card each
window length may take other convolution algorithms than the full forward,
so the stitched waveform equals the full forward to within f32 rounding, not
bit for bit.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
import torch

from wavthruvec_pytorch_tpu_torch.config import Vec2WavConfig


def conservative_context_frames(cfg: Vec2WavConfig) -> int:
    """An upper bound on the Generator's one-sided receptive field, in
    latent frames: conv_pre's reach plus each stage's (transposed conv and
    resblocks) reach, mapped back through the cumulative upsampling."""
    reach = 3.0  # conv_pre k=7 'same'
    up = 1
    if cfg.use_resblock1:
        # ResBlock1: per kernel, convs1 at dilations d[:3], each chained
        # with a dilation-1 convs2 conv
        dils = [list(d)[:3] + [1] * 3 for d in cfg.resblock_dilation_sizes]
    else:
        # ResBlock2: two convs per kernel, dilations d[:2]
        dils = [list(d)[:2] for d in cfg.resblock_dilation_sizes]
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        up *= u
        stage = float(k)  # the transposed conv's window (generous)
        for rk, rd in zip(cfg.resblock_kernel_sizes, dils):
            for d in rd:
                stage += (rk - 1) / 2 * d
        reach += stage / up
    return int(math.ceil(reach)) + 1


def _device_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


class StreamingVocoder:
    """Chunked Generator inference with exact overlap-trim stitching.
    ``gen`` is a serving Generator (``make_serving_generator``) holding its
    weights; the windows run on its device.

    >>> sv = StreamingVocoder(gen, cfg, chunk_frames=100)
    >>> for audio in sv.stream(latents, spk_emb, noise):  # [B, chunk*320]
    ...     play(audio)
    """

    def __init__(self, gen, cfg: Vec2WavConfig, chunk_frames: int = 100,
                 context_frames: Optional[int] = None):
        self.gen = gen
        self.cfg = cfg
        self.chunk = chunk_frames
        self.context = (context_frames if context_frames is not None
                        else conservative_context_frames(cfg))

    def stream(self, latents, spk_emb, noise,
               n_frames: Optional[int] = None) -> Iterator[np.ndarray]:
        """[B, T, C] latents (host or device) -> iterator of [B, n*320] f32
        audio chunks covering [0, T) in order (n == chunk_frames but
        possibly for the last)."""
        device = next(self.gen.parameters()).device
        lat = _device_tensor(latents, device)
        spk = _device_tensor(spk_emb, device)
        noise = _device_tensor(noise, device)
        up = self.cfg.total_upsample
        K, C = self.context, self.chunk
        T = lat.shape[1] if n_frames is None else int(n_frames)
        for t0 in range(0, T, C):
            n_out = min(C, T - t0)
            # edge chunks must see the true sequence edge for exactness
            lo = max(0, t0 - K)
            hi = min(T, t0 + n_out + K)
            wav = self.gen(lat[:, lo:hi].contiguous(), spk, noise)[..., 0]
            off = t0 - lo  # frames of left context actually present
            yield wav[:, off * up:(off + n_out) * up].float().cpu().numpy()

    def vocode(self, latents, spk_emb, noise, n_frames=None) -> np.ndarray:
        """Stream and concatenate (equals the full forward)."""
        return np.concatenate(list(self.stream(latents, spk_emb, noise, n_frames)), axis=1)
