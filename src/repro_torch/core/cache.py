"""Mixed-Precision Cache Management (paper §4.4.2; a copy of
``repro/core/cache.py``, plain Python).

An LRU cache over per-expert weight blobs extended with precision awareness,
governed by the paper's three rules:

  * **No Duplication** — an expert is resident in exactly one format.
  * **Precision Promotion** — a High request over a Low-resident expert is a
    miss: the High copy is loaded and the Low copy evicted.
  * **Conservative Reuse** — a Low request over a High-resident expert is a
    hit on the High copy (no extra I/O, no accuracy loss).

The cache is capacity-bounded in *bytes* (the edge VRAM budget). Loads are
charged to a transfer ledger the engine uses for TTFT/TPOT accounting; the
prefetcher calls ``prefetch`` which performs the same admission logic but is
charged to the overlap window instead of the critical path.
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

__all__ = ["CacheEntry", "MixedPrecisionLRUCache", "CacheStats"]

Key = Hashable  # (layer, expert)


@dataclasses.dataclass
class CacheEntry:
    key: Key
    precision: str        # "high" | "low"
    nbytes: int
    payload: object = None  # device buffers (or None in simulation mode)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    promotions: int = 0
    conservative_reuses: int = 0
    evictions: int = 0
    bytes_loaded: int = 0
    prefetch_bytes: int = 0
    prefetch_hits: int = 0
    # loads of blobs larger than the whole cache: streamed through without
    # ever becoming resident (see ``MixedPrecisionLRUCache.get``)
    bypass_loads: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


_RANK = {"low": 0, "high": 1}


class MixedPrecisionLRUCache:
    """Byte-budgeted LRU over (layer, expert) -> single-precision residency."""

    def __init__(self, capacity_bytes: int,
                 loader: Optional[Callable[[Key, str], Tuple[object, int]]] = None,
                 faults=None):
        """loader(key, precision) -> (payload, nbytes). In simulation mode
        (loader=None) the caller passes nbytes explicitly to get/prefetch.

        ``faults``: optional fault injector with ``fire``/``inflate``
        (duck-typed — this module never imports the serving layer). Two
        sites: ``cache.blob.corrupt`` raises on a demand load (a corrupted
        transfer), ``cache.blob.oversize`` inflates a loaded blob's size
        (driving the bypass ladder below)."""
        self.capacity = int(capacity_bytes)
        self._loader = loader
        self._faults = faults
        self._entries: "OrderedDict[Key, CacheEntry]" = OrderedDict()
        self._used = 0
        self.stats = CacheStats()
        # oversized-blob warnings are rate-limited to ONE per blob key —
        # the per-load count lives in stats.bypass_loads, not the log
        self._warned_bypass: set = set()

    # ------------------------------------------------------------ helpers
    def __contains__(self, key: Key) -> bool:
        return key in self._entries

    def resident_precision(self, key: Key) -> Optional[str]:
        e = self._entries.get(key)
        return e.precision if e else None

    def resident_nbytes(self, key: Key) -> int:
        e = self._entries.get(key)
        return e.nbytes if e else 0

    @property
    def used_bytes(self) -> int:
        return self._used

    def _touch(self, key: Key) -> None:
        self._entries.move_to_end(key)

    def _evict_until(self, need: int) -> None:
        while self._used + need > self.capacity and self._entries:
            _, old = self._entries.popitem(last=False)
            self._used -= old.nbytes
            self.stats.evictions += 1

    def _remove(self, key: Key) -> None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._used -= e.nbytes

    def _insert(self, key: Key, precision: str, nbytes: int,
                payload: object) -> CacheEntry:
        if nbytes > self.capacity:
            raise ValueError(
                f"entry {key} ({nbytes}B) exceeds cache capacity "
                f"({self.capacity}B)")
        self._evict_until(nbytes)
        entry = CacheEntry(key, precision, nbytes, payload)
        self._entries[key] = entry
        self._used += nbytes
        return entry

    def _load(self, key: Key, precision: str, nbytes: Optional[int]
              ) -> Tuple[object, int]:
        if self._loader is not None:
            return self._loader(key, precision)
        assert nbytes is not None, "simulation mode requires nbytes"
        return None, nbytes

    # ------------------------------------------------------------ API
    def _bypass(self, key: Key, precision: str, size: int,
                payload: object) -> CacheEntry:
        """Oversized blob (bigger than the whole cache budget): stream it
        through without admitting it. Crashing a serving request on a tiny
        VRAM budget would turn a capacity-planning problem into an outage;
        instead the load is charged in full as missed bytes every time
        (never resident => never a hit), counted in ``stats.bypass_loads``,
        and flagged with ONE warning per blob key (repeat loads of the
        same blob are silent — the count lives in the stats, not the
        log)."""
        if key not in self._warned_bypass:
            warnings.warn(
                f"expert blob {key} ({size}B) exceeds the entire cache "
                f"budget ({self.capacity}B); degrading to bypass loads — "
                "every request for it pays the full transfer (counted in "
                "stats.bypass_loads; further loads of this blob won't "
                "warn)")
            self._warned_bypass.add(key)
        self.stats.bypass_loads += 1
        return CacheEntry(key, precision, size, payload)

    def get(self, key: Key, precision: str, *,
            nbytes: Optional[int] = None) -> Tuple[CacheEntry, int]:
        """Request an expert at a precision. Returns (entry, bytes_missed) —
        bytes_missed > 0 means the transfer sits on the critical path."""
        assert precision in _RANK
        cur = self._entries.get(key)
        if cur is not None and _RANK[cur.precision] >= _RANK[precision]:
            # exact hit, or Conservative Reuse of a higher precision
            if cur.precision != precision:
                self.stats.conservative_reuses += 1
            self.stats.hits += 1
            self._touch(key)
            return cur, 0
        self.stats.misses += 1
        if self._faults is not None:   # chaos suite: corrupted transfer
            self._faults.fire("cache.blob.corrupt", key=key,
                              precision=precision)
        payload, size = self._load(key, precision, nbytes)
        if self._faults is not None:   # chaos suite: oversized blob
            size = self._faults.inflate("cache.blob.oversize", size)
        self.stats.bytes_loaded += size
        if size > self.capacity:
            # unadmittable high blob: stream it through but KEEP any
            # resident low copy — evicting it would turn every future
            # low request into a recurring miss for nothing
            return self._bypass(key, precision, size, payload), size
        if cur is not None:
            # Precision Promotion: treat as miss, evict the Low copy
            self.stats.promotions += 1
            self._remove(key)
        entry = self._insert(key, precision, size, payload)
        return entry, size

    def get_many(self, keys, precisions, nbytes):
        """Bulk ``get``: request several experts in one call, in order.

        ``keys`` / ``precisions`` / ``nbytes`` are parallel sequences; the
        entries are served front to back, so LRU touch order, promotions and
        evictions are exactly those of the equivalent ``get`` loop (the
        vectorized orchestrator replay relies on this). Returns (total
        bytes missed — the demand transfer sitting on the critical path —,
        per-key missed bytes, so the caller can tell which required keys
        were served by an already-resident copy)."""
        per_key = []
        get = self.get
        for key, prec, nb in zip(keys, precisions, nbytes):
            per_key.append(get(key, prec, nbytes=nb)[1])
        return sum(per_key), per_key

    def prefetch(self, key: Key, precision: str, *,
                 nbytes: Optional[int] = None) -> int:
        """Admit an expert ahead of use. Returns bytes transferred (0 if the
        request is already satisfied under the same rules as ``get``).
        A blob larger than the whole budget is not prefetched at all —
        it could never be admitted, so speculatively moving it would only
        burn DMA bandwidth (0 returned, nothing charged)."""
        cur = self._entries.get(key)
        if cur is not None and _RANK[cur.precision] >= _RANK[precision]:
            self._touch(key)
            return 0
        payload, size = self._load(key, precision, nbytes)
        if self._faults is not None:
            size = self._faults.inflate("cache.blob.oversize", size)
        if size > self.capacity:
            return 0  # keep any lower-precision copy — better than nothing
        if cur is not None:
            self._remove(key)
        self._insert(key, precision, size, payload)
        self.stats.prefetch_bytes += size
        return size

    def note_prefetch_hit(self) -> None:
        self.stats.prefetch_hits += 1

    def invariant_check(self) -> None:
        used = sum(e.nbytes for e in self._entries.values())
        assert used == self._used, (used, self._used)
        assert self._used <= self.capacity, (self._used, self.capacity)
        # No Duplication is structural: dict keyed by expert id.
