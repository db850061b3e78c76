"""Text frontend: char -> id against the AISHELL-3 vocab string.

The vocab file is a single line whose characters are the symbols; index =
position in the string.  Encoding drops unknown chars, prepends ``' '`` and
appends ``'E'`` (reference: text2vec/text.py:6-21).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

PAD = 0


class TextFrontend:
    def __init__(self, symbols: str):
        self.symbols = symbols
        self._symbol_to_id = {s: i for i, s in enumerate(symbols)}

    @classmethod
    def from_vocab_file(cls, vocab_path: str) -> "TextFrontend":
        with open(vocab_path, "r", encoding="utf-8") as fr:
            symbols = fr.readline()
        return cls(symbols)

    @property
    def vocab_size(self) -> int:
        return len(self.symbols)

    def text_to_sequence(
        self,
        text: str,
        add_eos_to_text: bool = True,
        prepend_space_to_text: bool = True,
    ) -> List[int]:
        seq = [self._symbol_to_id[s] for s in text if s in self._symbol_to_id]
        if prepend_space_to_text:
            seq.insert(0, self._symbol_to_id[" "])
        if add_eos_to_text:
            seq.append(self._symbol_to_id["E"])
        return seq

    def encode_batch(self, texts: Sequence[str], pad_to: int | None = None):
        """Encode + right-pad a batch to a static length -> ([B, L] int32 ids,
        [B] int32 lengths)."""
        seqs = [self.text_to_sequence(t) for t in texts]
        max_len = max(len(s) for s in seqs)
        if pad_to is not None:
            if pad_to < max_len:
                raise ValueError(f"pad_to={pad_to} < longest text {max_len}")
            max_len = pad_to
        out = np.zeros((len(seqs), max_len), dtype=np.int32)
        lengths = np.zeros((len(seqs),), dtype=np.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
            lengths[i] = len(s)
        return out, lengths


def pad_to_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value, else the largest bucket (JAX package:
    train/text2vec_train.py ``pad_to_bucket``); ``encode_batch`` then raises
    for a text longer than that."""
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]
