"""Figures for TensorBoard (JAX package: utils/plots.py; reference:
text2vec/log_utils.py:6-38, the alignment heatmap, and vec2wav/utils.py:11-22,
the spectrogram).  matplotlib is imported inside each function, so a run
that logs no image never needs it."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_figure_to_numpy(fig) -> np.ndarray:
    """A drawn figure -> HWC uint8 RGB."""
    data = np.frombuffer(fig.canvas.tostring_argb(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    return data.reshape(h, w, 4)[..., 1:]  # ARGB -> RGB


def plot_alignment_to_numpy(alignment: np.ndarray, title: str = "") -> np.ndarray:
    """[n_text, n_frames] attention map -> HWC uint8 image."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.canvas.draw()
    data = save_figure_to_numpy(fig)
    plt.close(fig)
    return data


def plot_spectrogram(spectrogram: np.ndarray):
    """[num_mels, frames] -> a matplotlib figure (TensorBoard's
    ``add_figure`` draws and closes it)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig
