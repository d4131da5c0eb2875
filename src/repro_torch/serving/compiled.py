"""The compiled decode chunk: the port's counterpart of the JAX engine's
``jax.jit(decode_many_batched, static_argnames=("num_steps",
"live_cap"))`` (``repro/serving/engine.py``).

Eager PyTorch dispatches every op of a decode step from the host (about
4,300 launches a step at full-width OLMoE-1B-7B), so the card waits on the
host. Here the whole chunk of ``num_steps`` steps is captured once as a
CUDA graph and then replayed with one launch:

* **One graph per key.** A key is (``num_slots``, ``slots_len``) — the
  decode state — and (``num_steps``, ``live_cap``, ``sampled``): the
  static arguments of the reference's jit, plus its greedy-only and
  sampled traces. Capture happens at a key's first call, as ``jax.jit``
  compiles at its first call. The scheduler's live-cap ladder bounds the
  keys to (ceil(log2 B) + 1) × 2 per ``num_steps``. All graphs share one
  memory pool.
* **Static buffers.** Each decode state owns its KV caches and the
  chunk's inputs (tokens, done, emitted counts, limits, EOS ids and, for
  sampled chunks, row keys, temperatures and top-k); a call copies its
  values in (host arrays through pinned memory, non-blocking). A graph's
  outputs (tokens, the four telemetry leaves, done, emitted) are fixed
  tensors: they hold a chunk's results until the next call of this object
  overwrites them (graphs share one pool, so ANY next call may), so a
  caller copies what it keeps first, on the same stream.
* **Engine-owned caches.** The graphs bind the caches' addresses, so the
  engine keeps decode states past a session's end and hands one out per
  session (:meth:`CompiledDecodeChunk.acquire`), reset to
  :func:`init_decode_state`'s values; graphs captured in one session
  replay in the next. A session holds its state until it releases it (or
  is dropped), so two live sessions never share one. Sessions ask for
  ``slots_len`` rounded up to a power of two (:func:`slot_bucket`), so a
  key recurs across request lengths, and the engine keeps at most
  ``max_idle_states`` states that no session holds, dropping the least
  recently used with its graphs: memory stays bounded however the lengths
  vary. Admission writes rows into a state in place.
* **Launch counts.** A kernel wrapper counts on the host when it launches
  (``LAUNCHES``); during capture it records a launch without running it.
  So a capture's counts are taken back, kept as the key's per-replay
  counts, and added at every replay.
* **No fallback.** On CUDA a capture or replay that fails raises. On the
  CPU (asked for by name) there are no graphs: the same static-buffer
  protocol runs an eager call of the chunk and writes its results into the
  same fixed outputs. ``graphs=False`` runs that eager protocol on the
  card too, which only a measurement asks for.
* **Which failures leave the state clean.** A warm-up (all rows frozen)
  and a capture write no cache, so an out-of-memory error from either
  reaches the caller as ``torch.OutOfMemoryError`` — the scheduler's
  dispatch ladder retries it with a shorter chunk (a new key). One raised
  by an eager chunk, which may have written the caches, is re-raised as a
  ``RuntimeError``, which the ladder lets through.

Before capture, one step of the key's shapes runs eagerly on a side stream
with every row frozen (a frozen row writes back the KV values it reads, so
the caches do not change): it builds the kernels, runs their one-time
attribute calls and torch's lazy initialization, none of which a capture
allows. Those launches are real and counted. Python's cyclic garbage
collector is off during a capture: a graph it destroyed then (say, of an
engine dropped earlier) would free that graph's pool, and a capture
forbids a ``cudaFree``.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.attn_scores import attn_scores as _attn
from repro_torch.kernels.quant_matmul import expert_quant_matmul as _eqm
from repro_torch.kernels.quant_matmul import quant_matmul as _qm
from repro_torch.models.kv_cache import KVCache
from repro_torch.models.model import DyMoEInfo, decode_many_batched, \
    init_decode_state

__all__ = ["CompiledDecodeChunk", "DecodeState", "ChunkOut", "slot_bucket"]

# every kernel wrapper's launch counter (name -> count)
_COUNTERS = (_eqm.LAUNCHES, _qm.LAUNCHES, _attn.LAUNCHES)

_INFO = ("critical_masks", "active_masks", "gate_mean", "predicted_next")

# host dtype of each static input's dtype
_NP = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32}


@dataclasses.dataclass
class ChunkOut:
    """A chunk's fixed outputs: tokens (T, B) int32, telemetry leaves
    (T, L, B, E), done (B,) bool, n_emitted (B,) int32."""

    tokens: torch.Tensor
    info: DyMoEInfo
    done: torch.Tensor
    n_emitted: torch.Tensor

    def tensors(self) -> List[torch.Tensor]:
        return [self.tokens, *(getattr(self.info, f) for f in _INFO),
                self.done, self.n_emitted]


@dataclasses.dataclass
class _Entry:
    out: ChunkOut
    graph: Optional[torch.cuda.CUDAGraph]
    launches: Dict[str, int]      # kernel launches one replay makes
    warmup_s: float = 0.0         # the eager one-step warm-up
    capture_s: float = 0.0        # capture and instantiation


def slot_bucket(need: int, max_seq_len: int) -> int:
    """The cache slots of a session whose requests need ``need``: the next
    power of two, but no more than ``max(need, max_seq_len)``."""
    return min(1 << max(need - 1, 0).bit_length(), max(need, max_seq_len))


class DecodeState:
    """The decode state of one slot batch: stacked KV caches
    (``caches["layers"]``), the chunk's static inputs and the compiled
    entries bound to them, keyed by (num_steps, live_cap, sampled)."""

    def __init__(self, cfg, num_slots: int, slots_len: int,
                 device: torch.device):
        b = self.num_slots = num_slots
        self.slots_len = slots_len
        self.caches: Dict[str, KVCache] = init_decode_state(
            cfg, b, slots_len, device)

        def z(dtype, *shape):
            return torch.zeros(shape or (b,), dtype=dtype, device=device)

        self.inputs = dict(
            tokens=z(torch.int32), done=z(torch.bool),
            n_emitted=z(torch.int32), limits=z(torch.int32),
            eos_tokens=z(torch.int32), rng_keys=z(torch.int64, b, 2),
            temperatures=z(torch.float32), top_ks=z(torch.int64))
        self.entries: Dict[Tuple[int, int, bool], _Entry] = {}
        self._holder = None           # () -> the holding session, or None

    @property
    def held(self) -> bool:
        """Whether a live session holds this state."""
        return self._holder is not None and self._holder() is not None

    def reset(self) -> None:
        """Back to :func:`init_decode_state`'s values: k and v zero,
        positions -1, length and offset 0."""
        c = self.caches["layers"]
        c.k.zero_()
        c.v.zero_()
        c.positions.fill_(-1)
        c.length.zero_()
        c.offset.zero_()


def _stage(dst: torch.Tensor, host) -> None:
    """Copy a host array into a static input without a stream sync
    (through pinned memory, non-blocking, on CUDA)."""
    src = torch.from_numpy(np.ascontiguousarray(host, dtype=_NP[dst.dtype]))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


def _counts() -> Dict[str, int]:
    return {k: v for c in _COUNTERS for k, v in c.items()}


def _set_counts(values: Dict[str, int]) -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = values[k]


class CompiledDecodeChunk:
    """``engine._decode_batched``: the scheduler's decode chunk, captured
    as one CUDA graph per key and replayed from engine-owned decode states
    (see the module docstring). ``graphs`` defaults to True on CUDA and
    must be False on the CPU.

    ``compiles`` counts the keys met for the first time (a capture on the
    card) and ``compile_s`` their seconds (warm-up included)."""

    # decode states kept while no session holds them
    max_idle_states = 4

    def __init__(self, engine, *, graphs: Optional[bool] = None):
        # the engine's model, not the engine (no reference cycle: an
        # engine and its graphs are freed when it is dropped)
        self._params, self._qparams = engine.params, engine.qparams
        self._cfg, self._device = engine.cfg, engine.device
        on_card = self._device.type == "cuda"
        self.graphs = on_card if graphs is None else graphs
        if self.graphs and not on_card:
            raise ValueError("CUDA graphs need the engine on a CUDA device")
        self._states: List[DecodeState] = []    # least recently used first
        self._pool = None
        self.compiles = 0
        self.compile_s = 0.0

    # ----------------------------------------------------------- states
    def acquire(self, num_slots: int, slots_len: int,
                owner=None) -> DecodeState:
        """A decode state for (``num_slots``, ``slots_len``) that no live
        session holds (a kept one, with its compiled entries, if there is
        one; else a new one), reset, and held by ``owner`` until
        :meth:`release` or ``owner``'s end (without an owner, until
        :meth:`release`)."""
        st = next((s for s in reversed(self._states) if not s.held
                   and (s.num_slots, s.slots_len) == (num_slots, slots_len)),
                  None)
        if st is None:
            st = DecodeState(self._cfg, num_slots, slots_len, self._device)
        else:
            self._states.remove(st)
            st.reset()
        self._states.append(st)
        st._holder = weakref.ref(owner) if owner is not None \
            else (lambda: True)
        self._evict()
        return st

    def release(self, state: DecodeState) -> None:
        """``state``'s session is over: the state is kept for a later one
        (the least recently used idle states beyond ``max_idle_states``
        are dropped)."""
        state._holder = None
        self._evict()

    def _evict(self) -> None:
        idle = [s for s in self._states if not s.held]
        for s in idle[:max(len(idle) - self.max_idle_states, 0)]:
            self._states.remove(s)     # its caches, outputs and graphs go
        if not any(e.graph is not None for s in self._states
                   for e in s.entries.values()):
            self._pool = None          # a pool no graph uses is not reused

    def states(self) -> List[DecodeState]:
        """The decode states kept, least recently acquired first."""
        return list(self._states)

    def pool_bytes(self) -> int:
        """Device bytes reserved by the graphs' shared memory pool."""
        if self._pool is None:
            return 0
        pid = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pid)

    # ------------------------------------------------------------- call
    def __call__(self, state: DecodeState, tokens: torch.Tensor, *,
                 num_steps: int, done, n_emitted, limits, eos_tokens,
                 live_cap: int, rng_keys=None, temperatures=None,
                 top_ks=None) -> ChunkOut:
        """One decode chunk of ``state``: ``tokens`` (B,) int32 on the
        device; ``done``, ``n_emitted``, ``limits``, ``eos_tokens`` and,
        for a sampled chunk, ``rng_keys`` (B, 2), ``temperatures`` and
        ``top_ks`` are host arrays. Semantics of
        :func:`~repro_torch.models.model.decode_many_batched`; the KV
        caches advance in place. Returns the key's fixed outputs."""
        ins = state.inputs
        ins["tokens"].copy_(tokens)
        host = dict(done=done, n_emitted=n_emitted, limits=limits,
                    eos_tokens=eos_tokens)
        sampled = rng_keys is not None
        if sampled:
            host.update(rng_keys=rng_keys, temperatures=temperatures,
                        top_ks=top_ks)
        for name, values in host.items():
            _stage(ins[name], values)
        key = (num_steps, live_cap, sampled)
        entry = state.entries.get(key)
        if not self.graphs:
            try:
                out = self._chunk(state, key)
            except torch.OutOfMemoryError as e:
                # the eager chunk may have written the caches already: not
                # an error a retry on this state could recover from
                raise RuntimeError("decode chunk ran out of memory after "
                                   "it began writing the decode state") from e
            if entry is None:
                state.entries[key] = _Entry(
                    out=out, graph=None, launches=dict.fromkeys(_counts(), 0))
                self.compiles += 1
                return out
            for dst, src in zip(entry.out.tensors(), out.tensors()):
                dst.copy_(src)
            return entry.out
        if entry is None:
            entry = state.entries[key] = self._capture(state, key)
        entry.graph.replay()
        for c in _COUNTERS:
            for k in c:
                c[k] += entry.launches[k]
        return entry.out

    def _chunk(self, state: DecodeState, key, done=None) -> ChunkOut:
        """The chunk run eagerly on ``state``'s static inputs (``done``
        overrides its done mask)."""
        num_steps, live_cap, sampled = key
        ins = state.inputs
        kw = {}
        if sampled:
            kw = dict(rng_keys=ins["rng_keys"],
                      temperatures=ins["temperatures"], top_ks=ins["top_ks"])
        toks, _, info, dn, emitted = decode_many_batched(
            self._params, self._cfg, ins["tokens"], state.caches,
            num_steps=num_steps,
            done=ins["done"] if done is None else done,
            n_emitted=ins["n_emitted"], limits=ins["limits"],
            eos_tokens=ins["eos_tokens"], qparams=self._qparams,
            live_cap=live_cap, **kw)
        return ChunkOut(toks, info, dn, emitted)

    def _capture(self, state: DecodeState, key) -> _Entry:
        """Warm up one step of ``key``'s shapes with every row frozen, then
        capture the chunk into the shared pool. The capture's launch
        counts become the entry's per-replay counts and are taken back."""
        _, live_cap, sampled = key
        t0 = time.perf_counter()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._chunk(state, (1, live_cap, sampled),
                        done=torch.ones_like(state.inputs["done"]))
        main.wait_stream(side)
        t1 = time.perf_counter()
        before = _counts()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self._pool):
                out = self._chunk(state, key)
        finally:
            if collecting:
                gc.enable()
            after = _counts()
            _set_counts(before)   # recorded, not launched (even if failed)
        entry = _Entry(out=out, graph=graph,
                       launches={k: after[k] - before[k] for k in after},
                       warmup_s=t1 - t0,
                       capture_s=time.perf_counter() - t1)
        self.compiles += 1
        self.compile_s += entry.warmup_s + entry.capture_s
        return entry
