"""A minimal byte-level tokenizer for the runnable examples.

Real deployments plug in a production tokenizer behind the same interface; the
serving engine only sees int32 token ids. A copy of ``repro.data.tokenizer``.
"""
from __future__ import annotations

from typing import List


class ByteTokenizer:
    """Bytes 0..255 plus specials. vocab_size = 256 + len(specials)."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259

    def encode(self, text: str, *, bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if bos else []) + ids

    def decode(self, ids) -> str:
        bs = bytes(i for i in ids if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")
