"""Text2Vec: FFT encoder with ECAPA speaker conditioning, duration predictor
and length regulator, FFT decoder, CBHG postnet (JAX package:
models/text2vec.py ``Encoder``, ``Decoder``, ``Text2Vec``; reference:
text2vec/model.py:71-356).

``Text2Vec.forward`` is the training branch: ConvAttention soft alignment,
MAS (``ops/mas.py``, the CUDA kernel on the card) and the hard-attention
expansion.  ``infer`` is the inference branch.

Semantics kept from the JAX package:

* position ids are clamped at ``vocab_size`` in the encoder and at
  ``max_seq_len`` in the decoder (a bare embedding lookup would raise);
* inference durations are ``floor((dp + 0.5) * alpha)``, zeroed at text pads;
* the decoder uses ``d_k = d_model // encoder_head`` (model.py:162);
* ``forward`` runs BatchNorm (ECAPA, CBHG) on batch statistics and dropout
  as the module's train/eval mode says (JAX: ``train_bn``,
  ``deterministic``); ``infer`` runs dropout in eval mode, and BatchNorm
  too unless ``train_bn`` asks for batch statistics (JAX's ``infer(...,
  train_bn=True)``, which only ``infer/recalibrate.py`` uses);
* with ``cfg.input_wav`` ECAPA takes raw 16 kHz waveforms ``[B, L]``
  (``models/ecapa.py``): ``infer``'s ``wav_feat`` is then the waveform, and
  ``forward`` takes it as ``ref_wav``, apart from the target features;
* ``dtype`` (``torch.bfloat16`` for ``compute_dtype="bfloat16"`` training)
  goes where JAX's ``Text2Vec(cfg, dtype)`` sends it: ECAPA, the FFT blocks,
  the duration predictor, ``WVF_linear``, the CBHG convolutions and
  ``last_linear``; ConvAttention stays f32.  Each of those layers returns its
  dtype, and f32 elsewhere follows the promotions (``models/layers.py``);
* ``cfg.flash_attention`` sends both FFT stacks through the flash branch
  where its gate passes (``models/fft_block.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, check_ported
from wavthruvec_pytorch_tpu_torch.device import resolve_device
from wavthruvec_pytorch_tpu_torch.models.cbhg import CBHG
from wavthruvec_pytorch_tpu_torch.models.conv_attention import ConvAttention
from wavthruvec_pytorch_tpu_torch.models.duration import DurationPredictor
from wavthruvec_pytorch_tpu_torch.models.ecapa import ECAPA_TDNN
from wavthruvec_pytorch_tpu_torch.models.fft_block import FFTBlock
from wavthruvec_pytorch_tpu_torch.models.layers import BatchNorm, Linear
from wavthruvec_pytorch_tpu_torch.ops.length_regulator import expand_by_durations
from wavthruvec_pytorch_tpu_torch.ops.mas import mas_width1
from wavthruvec_pytorch_tpu_torch.ops.masking import (
    get_attn_key_pad_mask,
    get_mask_from_lengths,
    get_non_pad_mask,
    positions_from_lengths,
)
from wavthruvec_pytorch_tpu_torch.ops.positional import sinusoid_encoding_table


def _position_table(n_position: int, d_hid: int, device) -> nn.Embedding:
    """Frozen sinusoid table kept as ``position_enc.weight`` (model.py:56-58)."""
    emb = nn.Embedding(n_position, d_hid, device=device)
    emb.weight.requires_grad_(False)
    with torch.no_grad():
        emb.weight.copy_(torch.from_numpy(sinusoid_encoding_table(n_position, d_hid, 0)))
    return emb


def _fft_stack(cfg: Text2VecConfig, d_model: int, d_inner: int, n_head: int,
               n_layer: int, dtype, device) -> nn.ModuleList:
    d_k = d_model // cfg.encoder_head  # the reference uses encoder_head in both stacks
    return nn.ModuleList(
        FFTBlock(d_model, d_inner, n_head, d_k, d_k,
                 fft_conv1d_kernel=cfg.fft_conv1d_kernel,
                 fft_conv1d_padding=cfg.fft_conv1d_padding, dropout=cfg.dropout,
                 use_flash=cfg.flash_attention, dtype=dtype, device=device)
        for _ in range(n_layer))


class Encoder(nn.Module):
    """Char embedding + clamped sinusoid positions + ECAPA speaker concat +
    FFT stack (n_position = vocab_size + 1, the reference's quirk, model.py:86)."""

    def __init__(self, cfg: Text2VecConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.src_word_emb = nn.Embedding(cfg.vocab_size, cfg.encoder_dim, device=device)
        self.position_enc = _position_table(cfg.vocab_size + 1, cfg.encoder_dim, device)
        if cfg.use_multi_speaker_condition:
            self.speaker_encoder = ECAPA_TDNN(cfg.spk_channel, cfg.n_feat_dim,
                                              cfg.n_speaker_dim, input_wav=cfg.input_wav,
                                              dtype=dtype, device=device)
        self.layer_stack = _fft_stack(cfg, cfg.encoder_output_dim,
                                      cfg.encoder_conv1d_filter_size, cfg.encoder_head,
                                      cfg.encoder_n_layer, dtype, device)

    def forward(self, src_seq: torch.Tensor, src_pos: torch.Tensor,
                wav_feat: Optional[torch.Tensor] = None,
                spk_emb: Optional[torch.Tensor] = None):
        cfg = self.cfg
        slf_attn_mask = get_attn_key_pad_mask(src_seq, src_seq)
        non_pad_mask = get_non_pad_mask(src_seq)
        # padding_idx=0 keeps the pad row at zero (model.py:88-90)
        text_emb = self.src_word_emb(src_seq) * non_pad_mask
        pos_ids = src_pos.clamp(max=cfg.vocab_size)
        enc_output = text_emb + self.position_enc(pos_ids)
        if cfg.use_multi_speaker_condition:
            if spk_emb is None:
                spk_emb = self.speaker_encoder(wav_feat)
            B, N, _ = enc_output.shape
            enc_output = torch.cat(
                [enc_output, spk_emb[:, None, :].expand(B, N, cfg.n_speaker_dim)], dim=-1)
        for layer in self.layer_stack:
            enc_output, _ = layer(enc_output, non_pad_mask, slf_attn_mask)
        return enc_output, spk_emb


class Decoder(nn.Module):
    """Clamped sinusoid positions + FFT stack over expanded frames."""

    def __init__(self, cfg: Text2VecConfig, dtype=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.position_enc = _position_table(cfg.max_seq_len + 1, cfg.decoder_model_dim, device)
        self.layer_stack = _fft_stack(cfg, cfg.decoder_model_dim,
                                      cfg.decoder_conv1d_filter_size, cfg.decoder_head,
                                      cfg.decoder_n_layer, dtype, device)

    def forward(self, enc_seq: torch.Tensor, enc_pos: torch.Tensor) -> torch.Tensor:
        slf_attn_mask = get_attn_key_pad_mask(enc_pos, enc_pos)
        non_pad_mask = get_non_pad_mask(enc_pos)
        dec_output = enc_seq + self.position_enc(enc_pos.clamp(max=self.cfg.max_seq_len))
        for layer in self.layer_stack:
            dec_output, _ = layer(dec_output, non_pad_mask, slf_attn_mask)
        return dec_output


class LengthRegulator(nn.Module):
    """Holds the duration predictor under the reference's attribute path
    (``length_regulator.duration_predictor``)."""

    def __init__(self, cfg: Text2VecConfig, dtype=None, device=None):
        super().__init__()
        self.duration_predictor = DurationPredictor(
            cfg.encoder_output_dim, cfg.duration_predictor_filter_size,
            cfg.duration_predictor_kernel_size, cfg.dropout, dtype=dtype, device=device)


@contextlib.contextmanager
def _eval_mode(module: nn.Module, train_bn: bool = False):
    """Run ``module`` in eval mode (its BatchNorms in train mode where
    ``train_bn``) and restore every submodule's mode afterwards."""
    if not module.training and not train_bn:
        yield
        return
    modes = {m: m.training for m in module.modules()}
    module.eval()
    if train_bn:
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.train()
    try:
        yield
    finally:
        for m, mode in modes.items():
            m.training = mode


class Text2Vec(nn.Module):
    """Text2Vec with reference parameter names; ``forward`` is the training
    branch, ``infer`` the inference branch.  ``device`` defaults to the card
    and raises without one.  ``dtype`` is the compute dtype (None: f32; the
    parameters are f32 either way), independent of ``cfg.compute_dtype``:
    the trainer passes bf16 for a bf16 config, serving builds f32, as the
    JAX package does.  The sinusoid position tables are frozen
    (``requires_grad=False``): they are not parameters of the JAX model, and
    the optimizer leaves them out."""

    def __init__(self, cfg: Text2VecConfig, device=None, dtype=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.encoder = Encoder(cfg, dtype=dtype, device=device)
        self.decoder = Decoder(cfg, dtype=dtype, device=device)
        self.length_regulator = LengthRegulator(cfg, dtype=dtype, device=device)
        self.WVF_linear = Linear(cfg.decoder_model_dim, cfg.n_feat_dim, dtype=dtype,
                                 device=device)
        self.postnet = CBHG(cfg.n_feat_dim, K=8, dtype=dtype, device=device)
        self.last_linear = Linear(2 * cfg.n_feat_dim, cfg.n_feat_dim, dtype=dtype,
                                  device=device)
        if cfg.learn_alignments:
            n_text = (cfg.encoder_dim + cfg.n_speaker_dim
                      if cfg.use_speaker_emb_for_alignment else cfg.encoder_dim)
            self.attention = ConvAttention(cfg.n_feat_dim, n_text,
                                           use_partial_padding=cfg.attn_use_partial_padding,
                                           device=device)

    @staticmethod
    def _mask_tensor(x: torch.Tensor, position: torch.Tensor, max_len: int) -> torch.Tensor:
        """Zero-fill frames beyond the per-item length (model.py:224-228)."""
        mask = get_mask_from_lengths(position.max(dim=-1).values, max_len)
        return x * mask[:, :, None].to(x.dtype)

    def forward(self, src_seq: torch.Tensor, src_pos: torch.Tensor, wav_feat: torch.Tensor,
                in_lens: torch.Tensor, out_lens: torch.Tensor, WVF_pos: torch.Tensor,
                attn_prior: Optional[torch.Tensor] = None,
                ref_wav: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Training branch (JAX: ``Text2Vec.__call__`` with MAS on).
        src_seq/src_pos [B, N] int, wav_feat [B, T, n_feat] (the target
        features, also ECAPA's and ConvAttention's input), in_lens/out_lens
        [B], WVF_pos [B, T] int, attn_prior [B, T, N] -> dict with
        ``feat_output``/``feat_postnet_output`` [B, T, n_feat],
        ``duration_predictor_output`` [B, N], ``duration`` [B, N] int32,
        ``attn`` (hard), ``attn_soft``, ``attn_logprob`` [B, T, N].
        With ``cfg.input_wav`` ECAPA takes ``ref_wav`` [B, L], the raw
        reference waveforms, in place of ``wav_feat``."""
        if self.cfg.input_wav and ref_wav is None:
            raise ValueError("Text2VecConfig.input_wav=True: pass the reference waveforms "
                             "as ref_wav [B, L]")
        spk_input = ref_wav if self.cfg.input_wav else wav_feat
        encoder_output, _ = self.encoder(src_seq, src_pos, spk_input)
        attn_soft, attn_logprob = self.attention(wav_feat, encoder_output, key_lens=in_lens,
                                                 attn_prior=attn_prior)
        attn_hard = mas_width1(attn_soft.detach(), in_lens, out_lens)
        duration = attn_hard.sum(dim=1).to(torch.int32)
        # hard-attention expansion; JAX takes its product in f32 whatever the
        # encoder's dtype (preferred_element_type), and attn_hard is 0/1
        lr_output = torch.matmul(attn_hard, encoder_output.float())
        dp_out = self.length_regulator.duration_predictor(encoder_output)

        max_len = wav_feat.shape[1]
        decoder_output = self.decoder(lr_output, WVF_pos)
        wvf_output = self._mask_tensor(self.WVF_linear(decoder_output), WVF_pos, max_len)
        residual = self.last_linear(self.postnet(wvf_output))
        wvf_postnet = self._mask_tensor(wvf_output + residual, WVF_pos, max_len)
        return {
            "feat_output": wvf_output,
            "feat_postnet_output": wvf_postnet,
            "duration_predictor_output": dp_out,
            "duration": duration,
            "attn": attn_hard,
            "attn_soft": attn_soft,
            "attn_logprob": attn_logprob,
        }

    @torch.inference_mode()
    def infer(self, src_seq: torch.Tensor, src_pos: torch.Tensor,
              wav_feat: Optional[torch.Tensor], max_frames: int, alpha: float = 1.0,
              spk_emb: Optional[torch.Tensor] = None,
              train_bn: bool = False) -> Dict[str, torch.Tensor]:
        """src_seq/src_pos [B, N] int, wav_feat [B, T_ref, n_feat] (with
        ``cfg.input_wav`` the waveforms [B, L]; or ``spk_emb`` [B,
        n_speaker_dim] to skip ECAPA) -> dict with
        ``feat_output``/``feat_postnet_output`` [B, max_frames, n_feat],
        ``duration_predictor_output`` [B, N], ``durations`` [B, N] and
        ``total_frames`` [B].  Runs in eval mode whatever the module's mode;
        ``train_bn`` runs the BatchNorms (ECAPA, CBHG) on batch statistics,
        which moves their running statistics (``infer/recalibrate.py``)."""
        with _eval_mode(self, train_bn):
            return self._infer(src_seq, src_pos, wav_feat, max_frames, alpha, spk_emb)

    def _infer(self, src_seq, src_pos, wav_feat, max_frames, alpha, spk_emb):
        encoder_output, _ = self.encoder(src_seq, src_pos, wav_feat, spk_emb=spk_emb)
        dp_out = self.length_regulator.duration_predictor(encoder_output)
        durations = torch.floor((dp_out + 0.5) * alpha).to(torch.int64)
        durations = durations * (src_seq != 0).to(torch.int64)

        lr_output, total_frames = expand_by_durations(encoder_output, durations, max_frames)
        wvf_pos = positions_from_lengths(total_frames, max_frames)

        decoder_output = self.decoder(lr_output, wvf_pos)
        wvf_output = self._mask_tensor(self.WVF_linear(decoder_output), wvf_pos, max_frames)
        residual = self.last_linear(self.postnet(wvf_output))
        wvf_postnet = self._mask_tensor(wvf_output + residual, wvf_pos, max_frames)
        return {
            "feat_output": wvf_output,
            "feat_postnet_output": wvf_postnet,
            "duration_predictor_output": dp_out,
            "durations": durations,
            "total_frames": total_frames,
        }

    @torch.inference_mode()
    def speaker_embedding(self, wav_feat: torch.Tensor) -> torch.Tensor:
        """[B, T_ref, n_feat] -> the ECAPA speaker embedding [B, n_speaker_dim],
        in eval mode."""
        with _eval_mode(self):
            return self.encoder.speaker_encoder(wav_feat)
