"""Byte-level tokenizer, no external vocab files (a copy of
``repro/data/tokenizer.py``).

Maps UTF-8 bytes to ids [0, 255]; ids >= 256 are reserved specials. Models
with larger vocabs simply have unused tail rows — fine for training-from-
scratch experiments and for exercising vocab-sharded embeddings.
"""
from __future__ import annotations

from typing import Iterable, List

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 259

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.BOS] + ids
        if add_eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8",
                                                       errors="replace")
