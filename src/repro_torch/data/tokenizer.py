"""Byte-level tokenizer for the LM substrate (offline: no external vocab).

Token ids 0..255 are raw bytes; id 256 = BOS, 257 = EOS, 258 = PAD.  The
assigned architectures have much larger vocabularies -- training examples
simply use the low id range, which exercises identical compute paths.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from ..obs.profile import phase as _phase

BOS = 256
EOS = 257
PAD = 258
VOCAB = 259


def encode(text: str, *, bos: bool = True, eos: bool = True) -> List[int]:
    ids = list(text.encode("utf-8"))
    if bos:
        ids.insert(0, BOS)
    if eos:
        ids.append(EOS)
    return ids


def decode(ids: Iterable[int]) -> str:
    data = bytes(i for i in ids if 0 <= i < 256)
    return data.decode("utf-8", errors="replace")


def pack(texts: Iterable[str], seq_len: int) -> np.ndarray:
    """Pack encoded texts into (N, seq_len) rows (train-time packing)."""
    with _phase("tokenize.pack"):
        stream: List[int] = []
        for t in texts:
            stream.extend(encode(t))
        n = max(1, len(stream) // seq_len)
        stream = stream[: n * seq_len]
        if not stream:
            stream = [PAD] * seq_len
            n = 1
        return np.asarray(stream, np.int32).reshape(n, seq_len)
