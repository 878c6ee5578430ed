"""Byte-level tokenizer: vocab = 256 raw bytes + BOS/EOS/PAD."""
from __future__ import annotations

import numpy as np

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> np.ndarray:
        ids = list(text.encode("utf-8", errors="replace"))
        if add_bos:
            ids = [BOS_ID] + ids
        return np.asarray(ids, dtype=np.int32)

    def decode(self, ids) -> str:
        raw = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return raw.decode("utf-8", errors="replace")

    def pad_to(self, ids: np.ndarray, length: int) -> np.ndarray:
        if len(ids) >= length:
            return ids[:length]
        out = np.full((length,), PAD_ID, dtype=np.int32)
        out[: len(ids)] = ids
        return out
