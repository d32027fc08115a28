"""Byte-level tokenizer (vocab 256 + specials), enough for the runnable
examples without external assets.  A copy of ``repro/data/tokenizer.py``."""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


def encode(text: str, add_bos: bool = True) -> np.ndarray:
    ids = list(text.encode("utf-8"))
    if add_bos:
        ids = [BOS] + ids
    return np.asarray(ids, np.int32)


def decode(ids) -> str:
    ids = [int(i) for i in np.asarray(ids).ravel() if int(i) < 256]
    return bytes(ids).decode("utf-8", errors="replace")
