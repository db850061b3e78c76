"""AISHELL-3-shaped demo dataset (JAX package: data/demo.py).  With the
same arguments it writes the same files, byte for byte:

    {root}/
      vocab.txt                  'PE ' + a seeded sample of CJK characters
      enc_train.txt enc_val.txt  'train/SSBxxxx/uN.npy|<text>|SSBxxxx' lines
      w2v_feat/train/SSBxxxx/uN.npy       [1, T, n_feat_dim] float32
      w2v_feat_tiny/train/SSBxxxx/uN.npy  the first 64 dims
      aishell3/train/wav/SSBxxxx/uN.wav   16 kHz int16, T * upsample samples
      spk_emb/SSBxxxx.npy        [192] float32
      text2vec.json vec2wav.json            full-size configs pointing here
      text2vec_tiny.json vec2wav_tiny.json  reduced ones for CPU runs

The data is learnable: each character has a fixed feature template, a
duration and a pitch; an utterance's features are its characters'
templates repeated for their durations plus a little noise, and its audio
a phase-continuous sine at their pitches.  Every draw comes from one
``np.random.default_rng(seed)`` in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from wavthruvec_pytorch_tpu_torch.config import Text2VecConfig, Vec2WavConfig, save_config

TINY_FEAT_DIM = 64  # the low-dimensional tree of the tiny configs


def _cjk_charset(n: int, seed: int = 0) -> str:
    """A seeded sample of CJK unified ideographs, in code point order."""
    rng = np.random.default_rng(seed)
    pts = rng.choice(np.arange(0x4E00, 0x9FA5), size=n, replace=False)
    return "".join(chr(int(p)) for p in sorted(pts))


def make_demo_data(root: str = "./data/demo", n_speakers: int = 2, n_utts: int = 6,
                   frames: Tuple[int, int] = (24, 40), n_feat_dim: int = 1024,
                   n_chars: int = 120, seed: int = 0, sampling_rate: int = 16000,
                   upsample: int = 320, max_frames: int = 0) -> str:
    """Write the demo tree under ``root`` and return ``root``.  ``max_frames``
    (0: none) drops an utterance's trailing characters past that many
    frames."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    charset = _cjk_charset(n_chars, seed)
    symbols = "PE " + charset  # the reference's vocabulary format
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write(symbols)

    lines = []
    chars = list(charset)
    templates = rng.standard_normal((len(chars), n_feat_dim)).astype(np.float32)
    pitches = 80.0 + 8.0 * rng.permutation(len(chars)) % 400
    char_index = {c: i for i, c in enumerate(chars)}
    for s in range(n_speakers):
        spk = f"SSB{s:04d}"
        feat_dir = os.path.join(root, "w2v_feat", "train", spk)
        tiny_dir = os.path.join(root, "w2v_feat_tiny", "train", spk)
        wav_dir = os.path.join(root, "aishell3", "train", "wav", spk)
        for d in (feat_dir, tiny_dir, wav_dir, os.path.join(root, "spk_emb")):
            os.makedirs(d, exist_ok=True)
        np.save(os.path.join(root, "spk_emb", f"{spk}.npy"),
                rng.standard_normal(192).astype(np.float32))
        spk_shift = 1.0 + 0.05 * s  # a mild pitch shift a speaker
        for u in range(n_utts):
            n_txt = int(rng.integers(4, max(5, frames[1] // 5)))
            txt_chars = list(rng.choice(chars, size=n_txt))
            # a character's duration is its own, as a phoneme's length is
            durs = np.array([3 + char_index[c] % 5 for c in txt_chars])
            if max_frames:
                keep = int(np.searchsorted(np.cumsum(durs), max_frames, side="right"))
                txt_chars, durs = txt_chars[:keep], durs[:keep]
            text = "".join(txt_chars)
            T = int(durs.sum())
            idx = np.repeat([char_index[c] for c in text], durs)
            feat = templates[idx] + 0.05 * rng.standard_normal((T, n_feat_dim)).astype(np.float32)
            feat = feat[None].astype(np.float32)
            np.save(os.path.join(feat_dir, f"u{u}.npy"), feat)
            np.save(os.path.join(tiny_dir, f"u{u}.npy"), feat[:, :, :TINY_FEAT_DIM])
            freqs = np.repeat(pitches[idx] * spk_shift, upsample)
            phase = np.cumsum(2 * np.pi * freqs / sampling_rate)
            wav_f = 0.5 * np.sin(phase) + 0.01 * rng.standard_normal(len(phase))
            wavfile.write(os.path.join(wav_dir, f"u{u}.wav"), sampling_rate,
                          (wav_f * 20000).astype(np.int16))
            lines.append(f"train/{spk}/u{u}.npy|{text}|{spk}")
    n_val = max(1, len(lines) // 6)
    with open(os.path.join(root, "enc_train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[n_val:]) + "\n")
    with open(os.path.join(root, "enc_val.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines[:n_val]) + "\n")

    # configs pointing at the tree, relative to the working directory
    t2v = Text2VecConfig(
        vocab_path=f"{root}/vocab.txt", vocab_size=len(symbols),
        feat_ground_truth=f"{root}/w2v_feat", train_list=(f"{root}/enc_train.txt",),
        val_list=(f"{root}/enc_val.txt",), betabinom_cache_path=f"{root}/align_prior",
        n_feat_dim=n_feat_dim, batch_size=2, batch_expand_size=2,
        # the reference's lr 0.1 suits B = 16 over a whole corpus; LAMB at 0.1
        # diverges on this tiny set, 0.01 converges
        learning_rate=0.01, epochs=2, log_step=5, save_step=100, val_step=50)
    v2w = Vec2WavConfig(
        feat_ground_truth=f"{root}/w2v_feat", train_wav_path=f"{root}/aishell3",
        spk_emb_path=f"{root}/spk_emb", input_training_file=f"{root}/enc_train.txt",
        input_validation_file=f"{root}/enc_val.txt", n_feat_dim=n_feat_dim, batch_size=2)
    save_config(t2v, os.path.join(root, "text2vec.json"))
    save_config(v2w, os.path.join(root, "vec2wav.json"))
    t2v_tiny = dataclasses.replace(
        t2v, feat_ground_truth=f"{root}/w2v_feat_tiny", n_feat_dim=TINY_FEAT_DIM,
        encoder_dim=32, decoder_dim=32, encoder_n_layer=1, decoder_n_layer=1,
        encoder_conv1d_filter_size=64, decoder_conv1d_filter_size=64,
        spk_channel=TINY_FEAT_DIM, n_speaker_dim=16, text_buckets=(16, 32), frame_buckets=(64,),
        duration_predictor_filter_size=16)
    v2w_tiny = dataclasses.replace(
        v2w, feat_ground_truth=f"{root}/w2v_feat_tiny", n_feat_dim=TINY_FEAT_DIM,
        num_wv_feat=TINY_FEAT_DIM, upsample_initial_channel=32,
        upsample_rates=(5, 4, 4, 2, 2), upsample_kernel_sizes=(11, 8, 8, 4, 4),
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 2)), periods=(2, 3),
        frame_buckets=(40,))
    save_config(t2v_tiny, os.path.join(root, "text2vec_tiny.json"))
    save_config(v2w_tiny, os.path.join(root, "vec2wav_tiny.json"))
    return root
