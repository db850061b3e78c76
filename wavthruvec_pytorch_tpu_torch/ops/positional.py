"""Sinusoid position-encoding table (JAX package: ops/positional.py;
reference: text2vec/model.py:37-56).

angle = pos / 10000^(2*(i//2)/d), sin on even dims, cos on odd dims, row
``padding_idx`` zeroed.  Built once on the host in float64, then cast.
"""

from __future__ import annotations

import numpy as np


def sinusoid_encoding_table(
    n_position: int, d_hid: int, padding_idx: int | None = None
) -> np.ndarray:
    positions = np.arange(n_position, dtype=np.float64)[:, None]
    dim_idx = np.arange(d_hid, dtype=np.float64)[None, :]
    angles = positions / np.power(10000.0, 2.0 * np.floor(dim_idx / 2.0) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table.astype(np.float32)
