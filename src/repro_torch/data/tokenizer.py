"""Byte-level tokenizer (vocab 256 + specials), mapped into each model's
vocab space.  Enough for end-to-end training/serving examples without
external tokenizer assets."""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


class ByteTokenizer:
    def __init__(self, vocab_size: int):
        assert vocab_size >= 256 + N_SPECIAL
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32) + N_SPECIAL
        if add_bos:
            ids = np.concatenate([[BOS], ids])
        return ids

    def decode(self, ids) -> str:
        ids = np.asarray(ids)
        ids = ids[(ids >= N_SPECIAL) & (ids < 256 + N_SPECIAL)] - N_SPECIAL
        return bytes(ids.astype(np.uint8)).decode("utf-8", errors="replace")
