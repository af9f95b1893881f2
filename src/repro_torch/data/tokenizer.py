"""Byte-level tokenizer (vocab 512: 256 bytes + specials + headroom).

Deterministic and dependency-free so the demo assets (max-sentiment,
max-caption) and HTTP examples run offline. IDs 0..255 are raw bytes;
specials start at 256.
"""

from __future__ import annotations

from typing import List

PAD_ID = 0          # NUL byte doubles as pad
BOS_ID = 256
EOS_ID = 257
SEP_ID = 258
VOCAB_SIZE = 512


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID
    sep_id = SEP_ID

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: List[int]) -> str:
        data = bytes(i for i in ids if 0 < i < 256)
        return data.decode("utf-8", errors="replace")


TOKENIZER = ByteTokenizer()
