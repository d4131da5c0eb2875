"""The engine's compiled programs: the port's counterparts of the JAX
engine's ``jax.jit(decode_many_batched, static_argnames=("num_steps",
"live_cap"))`` (:class:`CompiledDecodeChunk`), ``jax.jit(prefill,
static_argnames=("cache_slots", "row_local"))`` (:class:`CompiledPrefill`)
and ``jax.jit(decode_many, static_argnames=("num_steps", "top_k"))``
(:class:`CompiledDecodeMany`) (``repro/serving/engine.py``).

None of them is thread-safe: outputs are fixed tensors that the next call
overwrites, the launch counters are process-wide, and a capture fails if
another thread touches the device meanwhile. Callers hold the engine's
``lock`` over each call until they have read what they keep.

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
* **Static buffers.** Each decode state owns its caches (KV, or the
  SSM state, which does not depend on ``slots_len``, and the hybrid's
  shared-site KV stack) and the chunk's inputs (tokens, done, emitted
  counts, limits, EOS ids and, for sampled chunks, row keys,
  temperatures and top-k); a call copies its
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
  vary. A config with a sliding window never gets a bucket above its
  window W: its caches are rings of W slots (the token at position p in
  slot p % W), so a state's slot count is the reference's min(slots_len,
  W). Admission writes rows into a state in place.
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
with every row frozen (a frozen row writes back the KV values and SSM
state it reads, so the caches do not change): it builds the kernels,
runs their one-time attribute calls and torch's lazy initialization,
none of which a capture allows. Those launches are real and counted.
Python's cyclic garbage collector is off during a capture: a graph it
destroyed then (say, of an engine dropped earlier) would free that
graph's pool, and a capture forbids a ``cudaFree``.

The prefill (:class:`CompiledPrefill`) follows the same rules, with four
differences. Its key is the reference's jit key — the prompt shape (B, S),
``cache_slots`` and ``row_local`` — and what else fixes the program
(whether ``lengths`` and ``row_capacities`` are given, tokens or
``embeds``), so a ragged wave pads only to its own longest prompt. A
key's first call runs the prefill eagerly, and that call is the
capture's warm-up; the capture comes at the key's second call. A prompt
shape met once therefore costs no capture, and keeps no outputs: a
capture takes about an eager prefill's host time and holds its outputs'
memory, which varied traffic would pay for shapes it never meets again.
A prefill writes only tensors it allocates itself, so an out-of-memory
error from an eager prefill leaves nothing the caller keeps, and the
admission ladder retries it at half the wave (a new key, so an eager
call again). One raised inside a capture is re-raised as a
``RuntimeError``, which the ladder lets through: a failed capture is
not a sound state to retry from. The outputs of a captured key — the
logits, the ``DyMoEInfo`` leaves and the fresh caches, which the capture
allocates — live in a pool of the prefill graphs' own, apart from the
decode chunk's, so neither kind of replay overwrites the other's unread
outputs; the key's next call overwrites them. Each key owns its static
inputs; at most ``max_entries`` keys are kept, the least recently used
dropped with its graph.

``decode_many`` (:class:`CompiledDecodeMany`, the chunks of
``generate_reference`` and of the static batch) takes its warm-up rule
from the prefill — eager at a key's first call, captured at its second —
and its engine-owned decode states from the chunk: a caller copies the
prefill's caches into a state it holds for the whole request, so no graph
binds the prefill graphs' outputs. Its graphs have a pool of their own.
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.attn_scores import attn_scores as _attn
from repro_torch.kernels.quant_matmul import expert_quant_matmul as _eqm
from repro_torch.kernels.quant_matmul import quant_matmul as _qm
from repro_torch.models.kv_cache import KVCache, SSMCache, cache_tensors
from repro_torch.models.model import DyMoEInfo, decode_many, \
    decode_many_batched, init_decode_state, prefill

__all__ = ["CompiledDecodeChunk", "DecodeState", "ChunkOut",
           "CompiledPrefill", "PrefillOut", "CompiledDecodeMany", "ManyOut",
           "slot_bucket"]

# every kernel wrapper's launch counter (name -> count)
_COUNTERS = (_eqm.LAUNCHES, _qm.LAUNCHES, _attn.LAUNCHES)

_INFO = ("critical_masks", "active_masks", "gate_mean", "predicted_next")

# host dtype of each static input's dtype
_NP = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32}


@dataclasses.dataclass
class ChunkOut:
    """A chunk's fixed outputs: tokens (T, B) int32, telemetry leaves
    (T, L, B, E) (None for a non-MoE config), done (B,) bool, n_emitted
    (B,) int32."""

    tokens: torch.Tensor
    info: DyMoEInfo
    done: torch.Tensor
    n_emitted: torch.Tensor

    def tensors(self) -> List[torch.Tensor]:
        """Every output tensor (a non-MoE config's None leaves left out)."""
        return [t for t in (self.tokens, *(getattr(self.info, f)
                                           for f in _INFO),
                            self.done, self.n_emitted) if t is not None]


@dataclasses.dataclass
class ManyOut:
    """A ``decode_many`` call's outputs: tokens (T, B) int32 and the
    telemetry leaves (T, L, E) (None for a non-MoE config)."""

    tokens: torch.Tensor
    info: DyMoEInfo

    def tensors(self) -> List[torch.Tensor]:
        return [t for t in (self.tokens, *(getattr(self.info, f)
                                           for f in _INFO))
                if t is not None]


@dataclasses.dataclass
class PrefillOut:
    """A prefill's fixed outputs: last-token logits (B, V) f32, the fresh
    caches ({"layers": KVCache or SSMCache, "shared": the hybrid's site KV
    stack}) and the ``DyMoEInfo`` (its leaves None for a non-MoE
    config)."""

    logits: torch.Tensor
    caches: Dict[str, Union[KVCache, SSMCache]]
    info: DyMoEInfo

    def tensors(self) -> List[torch.Tensor]:
        """Every output tensor (None leaves left out)."""
        leaves = [self.logits]
        for part in sorted(self.caches):
            leaves += [t for _, t in cache_tensors(self.caches[part])]
        return leaves + [t for t in (getattr(self.info, f.name) for f in
                                     dataclasses.fields(self.info))
                         if t is not None]


@dataclasses.dataclass
class _Entry:
    out: Optional[Union[ChunkOut, PrefillOut]]   # None: no call yet fixed
    graph: Optional[torch.cuda.CUDAGraph]
    launches: Dict[str, int]      # kernel launches one replay makes
    warmup_s: float = 0.0         # the eager warm-up
    capture_s: float = 0.0        # capture and instantiation
    inputs: Optional[Dict[str, torch.Tensor]] = None  # a prefill key's


def slot_bucket(need: int, max_seq_len: int,
                window: Optional[int] = None) -> int:
    """The cache slots of a session whose requests need ``need``: the next
    power of two, but no more than ``max(need, max_seq_len)``, and no more
    than a sliding ``window`` (whose ring of W slots serves any length)."""
    bucket = min(1 << max(need - 1, 0).bit_length(), max(need, max_seq_len))
    return min(bucket, window) if window else bucket


class DecodeState:
    """The decode state of one batch: the stacked caches of
    :func:`init_decode_state` (``caches["layers"]``, a KVCache or an
    SSMCache, and the hybrid's ``caches["shared"]`` KV stack), the static
    inputs of its compiled program and the entries bound to them (a
    chunk's keyed by (num_steps, live_cap, sampled), a ``decode_many``'s
    by (num_steps, top_k, sampling mode))."""

    def __init__(self, cfg, num_slots: int, slots_len: int,
                 device: torch.device, inputs: Dict[str, torch.Tensor],
                 mesh=None):
        self.num_slots = num_slots
        self.slots_len = slots_len
        # under a mesh, this rank's block of the KV slots only
        self.caches: Dict[str, Union[KVCache, SSMCache]] = \
            init_decode_state(cfg, num_slots, slots_len, device, mesh=mesh)
        self.inputs = inputs
        self.entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._holder = None           # () -> the holder, or None

    @property
    def held(self) -> bool:
        """Whether a live session holds this state."""
        return self._holder is not None and self._holder() is not None

    def reset(self) -> None:
        """Back to :func:`init_decode_state`'s values: KV caches with k and
        v zero, positions -1, length and offset 0; SSM states zero."""
        for c in self.caches.values():
            if isinstance(c, SSMCache):
                for t in (c.conv_state, c.ssm_state, c.length):
                    t.zero_()
                continue
            c.k.zero_()
            c.v.zero_()
            c.positions.fill_(-1)
            c.length.zero_()
            c.offset.zero_()

    def load(self, caches: Dict[str, Union[KVCache, SSMCache]]) -> None:
        """Copy every leaf of ``caches`` (a prefill's, of this state's
        shapes) into the state's own caches."""
        for part, c in caches.items():
            mine = self.caches[part]
            assert getattr(mine, "ring", False) == getattr(c, "ring", False)
            for name, t in cache_tensors(c):
                getattr(mine, name).copy_(t)


def _chunk_inputs(b: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The static inputs of a decode chunk over ``b`` slots."""
    def z(dtype, *shape):
        return torch.zeros(shape or (b,), dtype=dtype, device=device)

    return dict(tokens=z(torch.int32), done=z(torch.bool),
                n_emitted=z(torch.int32), limits=z(torch.int32),
                eos_tokens=z(torch.int32), rng_keys=z(torch.int64, b, 2),
                temperatures=z(torch.float32), top_ks=z(torch.int64))


def _many_inputs(b: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The static inputs of a ``decode_many`` call over ``b`` rows."""
    def z(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(tokens=z(torch.int32, b), start_step=z(torch.int64),
                rng_key=z(torch.int64, 2), temperature=z(torch.float32),
                row_keys=z(torch.int64, b, 2),
                row_temperatures=z(torch.float32, b),
                row_top_ks=z(torch.int64, b))

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


def _add_counts(launches: Dict[str, int]) -> None:
    """A replay: add the launches its capture recorded."""
    for c in _COUNTERS:
        for k in c:
            c[k] += launches[k]


_THREAD = threading.local()


def _thread_libraries() -> None:
    """Run the calling thread's first products on the current device
    (f32 and bf16 ``mm``, ``addmm``, ``bmm``), once, outside any capture:
    they create the thread's cuBLAS handles, which are per thread, and
    creating one inside a capture fails (``CUBLAS_STATUS_NOT_INITIALIZED``)
    — a replica's driver thread may capture a key whose eager first call
    ran on another thread before this one ran any product."""
    dev = torch.cuda.current_device()
    ready = getattr(_THREAD, "devices", None)
    if ready is None:
        ready = _THREAD.devices = set()
    if dev in ready:
        return
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones((16, 16), dtype=dtype, device="cuda")
        torch.mm(x, x)
        torch.addmm(x, x, x)
        torch.bmm(x[None], x[None])
    ready.add(dev)


def _capture(pool, warmup: Optional[Callable[[], Any]],
             body: Callable[[], Any]) -> _Entry:
    """Run ``warmup()`` (if any) eagerly on a side stream, then capture
    ``body()`` into ``pool``. The capture's launch counts become the
    entry's per-replay counts and are taken back."""
    _thread_libraries()
    t0 = time.perf_counter()
    if warmup is not None:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warmup()
        main.wait_stream(side)
    t1 = time.perf_counter()
    before = _counts()
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        # thread_local: a CUDA call another thread makes meanwhile (a
        # sibling replica's driver freeing the pinned host copies of its
        # telemetry after its replay, say) must not invalidate this
        # capture; every unit of device work holds the engine's lock
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = body()
    finally:
        if collecting:
            gc.enable()
        after = _counts()
        _set_counts(before)   # recorded, not launched (even if failed)
    return _Entry(out=out, graph=graph,
                  launches={k: after[k] - before[k] for k in after},
                  warmup_s=t1 - t0, capture_s=time.perf_counter() - t1)


def _call_fixed(owner, entry: _Entry, run: Callable[[], Any],
                what: str) -> None:
    """A call of a key met before, for :class:`CompiledPrefill` and
    :class:`CompiledDecodeMany` (``owner``), whose first call ran ``run``
    eagerly as the warm-up. The second call sets up the key's fixed
    outputs: on the card it captures ``run()`` into ``owner``'s pool and
    replays it (an out-of-memory error inside the capture is re-raised as
    a ``RuntimeError``, which no retry ladder takes), else one eager call's
    outputs become them. Later calls replay, or refill them eagerly."""
    if entry.out is not None:
        if owner.graphs:
            entry.graph.replay()
            _add_counts(entry.launches)
        else:
            for dst, src in zip(entry.out.tensors(), run().tensors()):
                dst.copy_(src)
        return
    if not owner.graphs:
        entry.out = run()
    else:
        if owner._pool is None:
            owner._pool = torch.cuda.graph_pool_handle()
        try:
            cap = _capture(owner._pool, None, run)
        except torch.OutOfMemoryError as e:
            raise RuntimeError(f"the capture of {what} ran out of device "
                               "memory") from e
        entry.out, entry.graph = cap.out, cap.graph
        entry.launches, entry.capture_s = cap.launches, cap.capture_s
        entry.graph.replay()
        _add_counts(entry.launches)
    owner.compiles += 1
    owner.compile_s += entry.capture_s


def _pool_bytes(pool) -> int:
    """Device bytes reserved by a graph memory pool (0 without one)."""
    if pool is None:
        return 0
    pid = tuple(pool)
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pid)


class _StatePool:
    """Engine-owned decode states and the one graph pool of their
    compiled entries: the state machinery :class:`CompiledDecodeChunk` and
    :class:`CompiledDecodeMany` share. ``graphs`` defaults to True on CUDA
    and must be False on the CPU. ``eager`` (an engine over a mesh of more
    than one rank) runs every call eagerly into fresh outputs: no entry,
    no graph, no compile."""

    # decode states kept while nothing holds them
    max_idle_states = 4

    def __init__(self, engine, inputs: Callable, *,
                 graphs: Optional[bool] = None):
        # the engine's model, not the engine (no reference cycle: an
        # engine and its graphs are freed when it is dropped)
        self._params, self._qparams = engine.params, engine.qparams
        self._cfg, self._device = engine.cfg, engine.device
        self._mesh, self.eager = engine.mesh, engine.eager
        self._inputs = inputs
        on_card = self._device.type == "cuda" and not self.eager
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
        """A decode state for (``num_slots``, ``slots_len``) that nothing
        holds (a kept one, with its compiled entries, if there is one;
        else a new one), reset, and held by ``owner`` until
        :meth:`release` or ``owner``'s end (without an owner, until
        :meth:`release`)."""
        st = next((s for s in reversed(self._states) if not s.held
                   and (s.num_slots, s.slots_len) == (num_slots, slots_len)),
                  None)
        if st is None:
            st = DecodeState(self._cfg, num_slots, slots_len, self._device,
                             self._inputs(num_slots, self._device),
                             self._mesh)
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
        return _pool_bytes(self._pool)


class CompiledDecodeChunk(_StatePool):
    """``engine._decode_batched``: the scheduler's decode chunk, captured
    as one CUDA graph per key and replayed from engine-owned decode states
    (see the module docstring). ``graphs`` defaults to True on CUDA and
    must be False on the CPU.

    ``compiles`` counts the keys met for the first time (a capture on the
    card) and ``compile_s`` their seconds (warm-up included)."""

    def __init__(self, engine, *, graphs: Optional[bool] = None):
        super().__init__(engine, _chunk_inputs, graphs=graphs)

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
        if self.eager:
            return self._chunk(state, key)
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
        _add_counts(entry.launches)
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
            live_cap=live_cap, mesh=self._mesh, **kw)
        return ChunkOut(toks, info, dn, emitted)

    def _capture(self, state: DecodeState, key) -> _Entry:
        """Warm up one step of ``key``'s shapes with every row frozen, then
        capture the chunk into the shared pool."""
        _, live_cap, sampled = key
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        entry = _capture(
            self._pool,
            lambda: self._chunk(state, (1, live_cap, sampled),
                                done=torch.ones_like(state.inputs["done"])),
            lambda: self._chunk(state, key))
        self.compiles += 1
        self.compile_s += entry.warmup_s + entry.capture_s
        return entry


class CompiledPrefill:
    """``engine._prefill``: every prefill the engine and its sessions run
    (the batched row-local wave, the solo admission, the reference path's
    prefill). A key's first call runs eagerly; its second captures one
    CUDA graph, and every later call replays it from the key's static
    inputs into its fixed outputs (see the module docstring). ``graphs``
    defaults to True on CUDA and must be False on the CPU; with False the
    same protocol runs eager prefills, which on the card only a
    measurement asks for.

    A call's outputs stay valid until the next call of this object: a
    caller copies or injects what it keeps first, on the same stream.
    ``compiles`` counts the keys whose fixed outputs were set up at their
    second call (a capture on the card) and ``compile_s`` the captures'
    seconds. ``eager`` as in :class:`_StatePool`: every call a plain
    prefill into fresh outputs."""

    # keys kept (their static inputs and, once met twice, fixed outputs
    # and graphs); the least recently used beyond it is dropped
    max_entries = 8

    def __init__(self, engine, *, graphs: Optional[bool] = None):
        # the engine's model, not the engine (no reference cycle)
        self._params, self._qparams = engine.params, engine.qparams
        self._cfg, self._device = engine.cfg, engine.device
        self._mesh, self.eager = engine.mesh, engine.eager
        on_card = self._device.type == "cuda" and not self.eager
        self.graphs = on_card if graphs is None else graphs
        if self.graphs and not on_card:
            raise ValueError("CUDA graphs need the engine on a CUDA device")
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._pool = None
        self.compiles = 0
        self.compile_s = 0.0

    def entries(self) -> Dict[tuple, _Entry]:
        """The keys kept, least recently used first: (B, S, cache_slots,
        row_local, lengths given, row_capacities given, the embeds' dtype
        or None for tokens). A key met once has no outputs or graph."""
        return dict(self._entries)

    def pool_bytes(self) -> int:
        """Device bytes reserved by the prefill graphs' memory pool."""
        return _pool_bytes(self._pool)

    def _evict(self) -> None:
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)   # its outputs and graph go
        if not any(e.graph is not None for e in self._entries.values()):
            self._pool = None          # a pool no graph uses is not reused

    # ------------------------------------------------------------- call
    def __call__(self, tokens=None, *, embeds=None,
                 cache_slots: Optional[int] = None, lengths=None,
                 row_local: bool = False,
                 row_capacities=None) -> PrefillOut:
        """:func:`~repro_torch.models.model.prefill` of ``tokens`` (B, S),
        a host int array, or ``embeds`` (B, S, dm), a tensor; ``lengths``
        and ``row_capacities`` (B,) are host arrays. Returns the outputs
        of an eager prefill at a key's first call, else the key's fixed
        outputs; either is overwritten by the next call."""
        if tokens is not None:
            tokens = np.asarray(tokens)
        b, s = (tokens if tokens is not None else embeds).shape[:2]
        cfg = self._cfg
        key = (b, s,
               cache_slots or (cfg.sliding_window or max(s, cfg.max_seq_len)),
               row_local, lengths is not None, row_capacities is not None,
               None if embeds is None else embeds.dtype)
        entry = None if self.eager else self._entries.get(key)
        ins = entry.inputs if entry is not None else self._inputs(key)
        if tokens is not None:
            _stage(ins["tokens"], tokens)
        else:
            ins["embeds"].copy_(embeds, non_blocking=True)
        for name, values in (("lengths", lengths),
                             ("row_capacities", row_capacities)):
            if values is not None:
                _stage(ins[name], values)
        if self.eager:
            return self._prefill(key, ins)
        if entry is None:
            # the key's warm-up: one eager prefill, its outputs the call's
            out = self._prefill(key, ins)
            self._entries[key] = _Entry(out=None, graph=None, launches={},
                                        inputs=ins)
            self._evict()
            return out
        self._entries.move_to_end(key)
        try:
            _call_fixed(self, entry, lambda: self._prefill(key, ins),
                        f"prefill key {key}")
        finally:
            self._evict()
        return entry.out

    def _inputs(self, key) -> Dict[str, torch.Tensor]:
        """A key's static inputs, allocated outside any graph pool."""
        b, s, _, _, has_lengths, has_caps, embeds_dtype = key
        dev = self._device
        if embeds_dtype is None:
            ins = dict(tokens=torch.zeros((b, s), dtype=torch.int64,
                                          device=dev))
        else:
            ins = dict(embeds=torch.zeros((b, s, self._cfg.d_model),
                                          dtype=embeds_dtype, device=dev))
        if has_lengths:
            ins["lengths"] = torch.zeros(b, dtype=torch.int32, device=dev)
        if has_caps:
            ins["row_capacities"] = torch.zeros(b, dtype=torch.int64,
                                                device=dev)
        return ins

    def _prefill(self, key, ins) -> PrefillOut:
        """The prefill run eagerly on the key's static inputs."""
        logits, caches, info = prefill(
            self._params, self._cfg, ins.get("tokens"),
            embeds=ins.get("embeds"), qparams=self._qparams,
            cache_slots=key[2], lengths=ins.get("lengths"),
            row_local=key[3], row_capacities=ins.get("row_capacities"),
            mesh=self._mesh)
        return PrefillOut(logits, caches, info)


class CompiledDecodeMany(_StatePool):
    """``engine._decode_many``: :func:`~repro_torch.models.model.decode_many`
    chunks of ``generate_reference`` and the static batch baseline, one
    CUDA graph per key on the card (see the module docstring for what it
    shares with the other two).

    A caller takes a decode state for its batch (B, cache slots) with
    :meth:`acquire`, passing the prefill's caches: they are COPIED into the
    state, so no graph binds the prefill graphs' outputs, which the next
    prefill overwrites; the caller then holds nothing that aliases another
    call's outputs, and :meth:`release` hands the state back at its end.
    Within a state a key is (``num_steps``, ``top_k``, mode): greedy,
    sampled with one key (``rng_key``, a tensor ``temperature``), or
    sampled per row (``row_keys``, ``row_temperatures``, ``row_top_ks``).
    As in :class:`CompiledPrefill`, a key's first call runs eagerly (its
    warm-up), its second captures and replays, later calls replay; at most
    ``max_entries`` keys a state are kept, the least recently used dropped
    with its graph. ``start_step``, the temperature and the keys are
    static inputs, so a request's later chunks replay the same graph.
    ``compiles`` counts the keys whose fixed outputs were set up (a
    capture on the card) and ``compile_s`` the captures' seconds."""

    max_entries = 8

    def __init__(self, engine, *, graphs: Optional[bool] = None):
        super().__init__(engine, _many_inputs, graphs=graphs)

    def acquire(self, num_slots: int, slots_len: int, owner=None, *,
                caches=None) -> DecodeState:
        """A state as :meth:`_StatePool.acquire` gives it, with ``caches``
        (a prefill's, (B = ``num_slots``, ``slots_len`` slots)) copied
        in."""
        st = super().acquire(num_slots, slots_len, owner)
        if caches is not None:
            st.load(caches)
        return st

    def __call__(self, state: DecodeState, tokens: torch.Tensor, *,
                 num_steps: int, start_step: int = 0, rng_key=None,
                 temperature: float = 0.0, top_k: int = 0, row_keys=None,
                 row_temperatures=None, row_top_ks=None) -> ManyOut:
        """``num_steps`` steps of :func:`decode_many` on ``state``'s caches
        (advanced in place) from ``tokens`` (B,) on the device; the keys and
        per-row sampling values are host arrays. Returns the eager outputs
        at a key's first call, else the key's fixed outputs; either is
        overwritten by the next call."""
        ins = state.inputs
        ins["tokens"].copy_(tokens)
        ins["start_step"].fill_(int(start_step))
        if row_keys is not None:
            mode, top_k = "rows", 0
            for name, values in (("row_keys", row_keys),
                                 ("row_temperatures", row_temperatures),
                                 ("row_top_ks", row_top_ks)):
                _stage(ins[name], values)
        elif rng_key is not None and temperature > 0.0:
            mode = "sampled"
            _stage(ins["rng_key"], np.asarray(rng_key, np.int64))
            ins["temperature"].fill_(float(temperature))
        else:
            if temperature > 0.0:
                warnings.warn("decode_many: temperature > 0 but no PRNG "
                              "key was provided; falling back to greedy "
                              "decoding")
            mode, top_k = "greedy", 0
        key = (num_steps, top_k, mode)
        if self.eager:
            return self._many(state, key)
        entry = state.entries.get(key)
        if entry is None:
            # the key's warm-up: one eager call, its outputs the call's
            out = self._many(state, key)
            state.entries[key] = _Entry(out=None, graph=None, launches={})
            while len(state.entries) > self.max_entries:
                state.entries.popitem(last=False)
            self._evict()
            return out
        state.entries.move_to_end(key)
        _call_fixed(self, entry, lambda: self._many(state, key),
                    f"decode_many key {key}")
        return entry.out

    def _many(self, state: DecodeState, key) -> ManyOut:
        """The call run eagerly on ``state``'s static inputs."""
        num_steps, top_k, mode = key
        ins = state.inputs
        kw = {}
        if mode == "sampled":
            kw = dict(rng_key=ins["rng_key"], temperature=ins["temperature"],
                      top_k=top_k)
        elif mode == "rows":
            kw = dict(row_keys=ins["row_keys"],
                      row_temperatures=ins["row_temperatures"],
                      row_top_ks=ins["row_top_ks"])
        toks, _, info = decode_many(
            self._params, self._cfg, ins["tokens"], state.caches,
            num_steps=num_steps, start_step=ins["start_step"],
            qparams=self._qparams, mesh=self._mesh, **kw)
        return ManyOut(toks, info)
