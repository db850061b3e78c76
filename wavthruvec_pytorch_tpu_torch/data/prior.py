"""Beta-binomial diagonal attention prior, cached on disk per (tokens,
frames) (JAX package: data/prior.py; reference: text2vec/dataset.py:24-55).

Row i of M frames is ``BetaBinom(P-1, s*i, s*(M+1-i)).pmf(arange(P))``,
computed on the host with scipy for all rows at once and cached as
``{P}_{M}_prior.npy``.
"""

from __future__ import annotations

import os

import numpy as np


def beta_binomial_prior_distribution(phoneme_count: int, mel_count: int,
                                     scaling_factor: float = 0.05) -> np.ndarray:
    """[mel_count, phoneme_count] float64 prior (reference: dataset.py:24-35)."""
    from scipy.stats import betabinom

    P, M = phoneme_count, mel_count
    i = np.arange(1, M + 1)[:, None]
    return betabinom(P - 1, scaling_factor * i, scaling_factor * (M + 1 - i)).pmf(np.arange(P)[None])


def get_attention_prior(n_tokens: int, n_frames: int, cache_path: str = "./data/align_prior",
                        scaling_factor: float = 1.0) -> np.ndarray:
    """[n_frames, n_tokens] float32 prior, read from or written to the
    ``.npy`` cache (reference: dataset.py:38-55)."""
    os.makedirs(cache_path, exist_ok=True)
    prior_path = os.path.join(cache_path, f"{n_tokens}_{n_frames}_prior.npy")
    if os.path.exists(prior_path):
        return np.load(prior_path)
    prior = beta_binomial_prior_distribution(n_tokens, n_frames, scaling_factor).astype(np.float32)
    np.save(prior_path, prior)
    return prior
