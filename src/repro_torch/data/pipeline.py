"""Token data pipeline: synthetic corpora, file-backed text, packing,
deterministic shuffling, infinite batch iterators. NumPy only: a copy of
``repro/data/pipeline.py``, so its batches equal the reference's bit for
bit; the train loop moves them to the device.

Synthetic data is a structured Markov-ish mixture (not uniform noise) so
small models trained on it have real signal: loss decreases and routing
develops non-uniform expert loads — which DyMoE's skewness observations
(paper §3.1) depend on.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["DataConfig", "synthetic_lm_batches", "text_file_batches",
           "pack_documents"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    vocab_size: int
    seed: int = 0


def _markov_doc(rng: np.random.Generator, vocab: int, length: int,
                n_modes: int = 8) -> np.ndarray:
    """Sample a document from one of n_modes sticky Markov token regimes.
    Each mode concentrates on a distinct vocab band — inputs from different
    modes route to different experts, giving the input-dependent skew of
    paper Fig. 4."""
    mode = int(rng.integers(n_modes))
    band = vocab // n_modes
    lo = mode * band
    toks = np.empty(length, np.int64)
    cur = int(rng.integers(lo, lo + band))
    for i in range(length):
        toks[i] = cur
        if rng.random() < 0.15:  # jump within band
            cur = int(rng.integers(lo, lo + band))
        else:  # local drift
            cur = lo + (cur - lo + int(rng.integers(1, 5))) % band
    return toks


def synthetic_lm_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    while True:
        toks = np.stack([
            _markov_doc(rng, cfg.vocab_size, cfg.seq_len + 1)
            for _ in range(cfg.batch_size)])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def pack_documents(docs: Sequence[Sequence[int]], seq_len: int,
                   pad_id: int = 0) -> np.ndarray:
    """Greedy packing of variable-length docs into fixed seq_len rows."""
    rows: List[List[int]] = []
    cur: List[int] = []
    for d in docs:
        d = list(d)
        while d:
            space = seq_len + 1 - len(cur)
            cur.extend(d[:space])
            d = d[space:]
            if len(cur) == seq_len + 1:
                rows.append(cur)
                cur = []
    if cur:
        cur.extend([pad_id] * (seq_len + 1 - len(cur)))
        rows.append(cur)
    return np.asarray(rows, np.int32)


def text_file_batches(path: str, cfg: DataConfig, tokenizer
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministically shuffled epochs over a newline-delimited text file."""
    with open(path) as f:
        docs = [tokenizer.encode(line.strip(), add_eos=True)
                for line in f if line.strip()]
    packed = pack_documents(docs, cfg.seq_len, pad_id=0)
    epoch = 0
    while True:
        seed = int.from_bytes(hashlib.sha256(
            f"{cfg.seed}:{epoch}".encode()).digest()[:4], "little")
        order = np.random.default_rng(seed).permutation(len(packed))
        for i in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
            rows = packed[order[i:i + cfg.batch_size]]
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        epoch += 1
