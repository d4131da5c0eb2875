"""Step-driven continuous-batching scheduler — an OPEN serving session
(``submit`` / ``step`` / ``stream`` / ``cancel``) over a fixed slot batch
(torch port of ``repro/serving/scheduler.py``):

    handle = session.submit(request)   # validated, queued (lock-guarded:
                                       #   legal from any thread)
    session.step()                     # ONE chunk boundary:
                                       #   1. finish a replay-fault
                                       #      recovery; shed expired (and,
                                       #      under EDF, infeasible) queued
                                       #      requests; free the slots of
                                       #      cancelled / expired rows
                                       #   2. SLO pressure rung, at most
                                       #      one preemption (EDF)
                                       #   3. admission wave(s) into free
                                       #      slots (one ragged row-local
                                       #      prefill per wave of >1
                                       #      request; the solo prefill for
                                       #      a wave of one; the engine's
                                       #      compiled prefill: a CUDA
                                       #      graph replay on the card),
                                       #      each with ONE host sync for
                                       #      its first tokens, then its
                                       #      replay and the injection of
                                       #      its rows
                                       #   4. one decode chunk of
                                       #      ``decode_chunk`` steps over
                                       #      every slot (the engine's
                                       #      compiled chunk: a CUDA graph
                                       #      replay on the card)
                                       #   5. ONE host sync: done/emitted
                                       #      masks and the chunk's tokens;
                                       #      finished rows are evicted,
                                       #      then the chunk's replay
    handle.stream()                    # TokenChunk events, replay order
    handle.cancel()                    # slot freed at the next boundary
    handle.result()                    # GenerationResult (or its typed
                                       #   ServingError, raised)

**Telemetry to the host without another sync.** A chunk's (T, L, B, E)
Critical / active masks and look-ahead predictions (and a wave's) are
copied to pinned host buffers with ``non_blocking`` copies queued on the
stream BEFORE the boundary's one blocking fetch, so that fetch's stream
sync also completes them. The replay, run after the fetch, reads
finished host memory.

**Replay** runs through ONE shared orchestrator per session (requests
share the edge device's expert cache, as they would share its VRAM), wave
by wave and chunk by chunk in dispatch order. Each wave's and chunk's
replay is a job submitted after its boundary sync to the session's
:class:`~repro_torch.serving.engine.ReplayStream`; the job holds only
host memory (the fetched tokens and the telemetry's pinned copies, which
that sync completed), never a CUDA tensor. With ``pipeline=True`` (the
default, as in the JAX package) ONE worker thread runs the jobs in FIFO
order while the dispatch thread goes on to the next chunk::

      device   ─[ chunk N ]──────[ chunk N+1 ]────[ chunk N+2 ]─→
      dispatch ──┤ sync, evict, admit, dispatch ├──┤ sync ... ├──→
                     │ submit replay job N (FIFO)
      worker   ────[ replay N-1 ]──────[ replay N ]────────────→

FIFO over one orchestrator is the serial order, so the modeled TTFT/TPOT
are bitwise those of ``pipeline=False``, which runs every job inline at
its boundary (the serial mode). A full queue (``max_inflight_chunks``)
blocks the dispatch thread at its submit, after the engine's lock is let
go. A request's ``GenerationResult`` is finalized, and its stream events
pushed, by the replay of its telemetry; its wall clocks stop at the host
sync that fetched its last token.

**One engine, many sessions.** Sessions over one engine (the replicas of
``serving/cluster``) may be driven from different threads. The engine's
compiled programs are not thread-safe, so each unit of device work holds
the engine's ``lock``: an admission wave from its prefill through the
injection of its rows, a decode chunk from its dispatch through its
readout. The replay is submitted after the lock is let go, and the
worker never takes it (it takes only the session's own ``_lock``).

**Decode state.** The slot batch's KV caches belong to the engine, because
the compiled chunk's graphs bind their addresses: a session holds one of
the engine's decode states from its start to :meth:`close` (``slots_len``
rounded up to a power of two, so later sessions find it again; with a
sliding window W, no more than W: the caches are then rings of W
slots), reset at the start; admission writes rows into it in place. The chunk's outputs
are fixed buffers that the next chunk overwrites, so the session copies
the last tokens into its own ``_tok_d`` and queues the telemetry copies
before the next dispatch. A wave's prefill outputs are fixed buffers too,
which the next prefill overwrites: each wave's first tokens are fetched,
its telemetry copied and its rows injected before the next wave's
prefill.

Admitted KV rows are LEFT-ALIGNED into their slots, so an injected row
is laid out exactly as a solo admission would have been; an SSM state is
copied as it is. SSM and hybrid configs admit one exact-shape solo
prefill per request (a ragged wave would thread pads through the scan),
as do windowed configs (a ragged prefill into a ring is refused).
Rows are independent programs (row-local Critical sets, per-row PRNG streams
indexed by the request's own token position), so a request's tokens do
not depend on its neighbours, the chunk length or its slot — which is
what makes every recovery rung below token-exact.

**Slots over a mesh's data axes.** On an engine whose mesh has data axes
above 1 ("pod", "data"), a session whose slot count they divide splits
its slots in blocks over the data ranks (``Mesh.batch_block``); every
device program runs on the rank's model sub-group alone
(``Mesh.model_view``), over its block only. Each data rank prefills the
admission rows headed for its own slots (the slot each would take were
every candidate to survive; a survivor that a candidate finishing at its
first token moves across a block edge is prefilled again on its new
rank), so no KV crosses data ranks. The two host fetches — a wave's first
tokens, a chunk's done / emitted / tokens — each become ONE exact gather
over "data" of the rows with their telemetry, then the fetch: every rank
then holds every row and takes rank 0's decisions itself. ``live_cap`` is
a rank's own (its live rows in its block, on the ladder up to its block's
size): a row's output does not depend on it, and each rank's MoE regions
fit its own rows. A slot count the data ranks do not divide, and a
full-precision MoE (its rows run as one batch of global capacity), is
replicated: every data rank runs the whole session.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from functools import partial
from typing import Deque, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.orchestrator import StepTiming
from repro_torch.models.kv_cache import SSMCache
from repro_torch.models.layers.moe import _capacity
from repro_torch.serving.compiled import slot_bucket
from repro_torch.serving.engine import ReplayStream
from repro_torch.serving.faults import NO_FAULTS, AdmissionError, \
    DeadlineExceeded, DispatchError, InjectedFault, QueueFull, \
    ReplayError, SessionClosed, SessionHealth
from repro_torch.serving.policy import SchedulingPolicy, SLOPressure, \
    effective_deadline, estimate_service_s, make_policy
from repro_torch.serving.request import Request, RequestHandle, TokenChunk
from repro_torch.serving.sampler import fold_in, raw_key_data, \
    resolve_sampling, sample_token_rows

__all__ = ["SchedulerConfig", "ContinuousBatchingScheduler",
           "live_cap_for"]


def live_cap_for(n_live: int, slots: int) -> int:
    """The static-capacity ladder: a power of two >= ``n_live``, clamped
    to ``slots`` — at most log2(slots) + 1 distinct MoE region sizes."""
    return min(slots, 1 << max(0, n_live - 1).bit_length())


# What the dispatch and admission ladders recover from: injected faults,
# and an allocation failure raised before the work wrote any state the
# session keeps (an admission wave's prefill writes only the compiled
# prefill's own outputs until its rows are injected, and the compiled
# prefill turns an out-of-memory error of a capture into a RuntimeError;
# the compiled chunk raises its out-of-memory errors only from capture,
# before a launch, and turns one raised after its eager chunk began
# writing the caches into a RuntimeError). Anything
# else — a kernel build failure, a CUDA launch or device error, which
# stays on the context — propagates out of ``step()``: a retry against it
# would only end in a DispatchError while the run looked healthy.
_LADDER_ERRORS = (InjectedFault, torch.OutOfMemoryError)


def _h2d(a, device: torch.device) -> torch.Tensor:
    """A small host array on ``device`` without a stream sync (pinned,
    non-blocking copy on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _d2h_async(tensors):
    """Queue copies of device tensors into pinned host memory; they are
    complete once a later blocking fetch on the same stream returns (on
    the CPU, plain copies: the compiled chunk's outputs are overwritten by
    the next chunk). None leaves (a non-MoE config's telemetry) stay
    None."""
    return tuple(None if x is None else x.to("cpu", non_blocking=True,
                                             copy=True) for x in tensors)


def _numpy(tensors):
    """Host tensors as numpy arrays (None stays None)."""
    return tuple(None if x is None else x.numpy() for x in tensors)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_slots: int = 4            # concurrent device slots (decode batch)
    max_chunks: Optional[int] = None  # run() safety valve; None = auto
    pipeline: bool = True         # replay on a worker, overlapping decode
    # replay-queue bound: a slow host replay blocks the dispatch thread's
    # submit instead of piling up telemetry
    max_inflight_chunks: int = 4
    # per-slot cache length for OPEN sessions (submit/step); None defaults
    # to sliding_window or cfg.max_seq_len (rounded to a power of two but
    # never above the window, see ``slot_bucket``). run() sizes it to its
    # workload.
    slots_len: Optional[int] = None
    # admission-queue bound: submits beyond it raise a typed QueueFull
    # (backpressure) instead of growing latency unbounded. None = no bound.
    max_queue: Optional[int] = None
    # SLO scheduling policy: "fifo" (default — blind FIFO admission, the
    # bit-exactness oracle), "edf" (priority + earliest-deadline-first
    # admission, proactive infeasibility shedding, chunk-boundary
    # preemption, pressure degradation ladder), or a SchedulingPolicy
    # instance (repro_torch.serving.policy)
    policy: Union[str, SchedulingPolicy, None] = "fifo"


@dataclasses.dataclass
class _SlotState:
    """Host-side bookkeeping for one admitted request; the replay of its
    last telemetry finalizes it."""

    handle: RequestHandle
    request: Request
    tokens: List[int]
    prompt_len: int
    admit_t: float                # perf_counter at admission
    queue_wait_s: float           # submission -> admission
    finish_now: bool = False      # one-token request: finalize at prefill
    decode_t0: float = 0.0        # first token on host
    end_t: float = 0.0            # last token on host
    ttft_s: float = 0.0           # set by the prefill replay
    prefill_timing: Optional[StepTiming] = None
    prefill_weight_bytes: int = 0
    step_totals: List[float] = dataclasses.field(default_factory=list)
    decode_timings: List[StepTiming] = dataclasses.field(
        default_factory=list)
    decode_weight_bytes: int = 0


class ContinuousBatchingScheduler:
    """Serve a stream of requests through ``num_slots`` device slots on
    top of a :class:`~repro_torch.serving.engine.DyMoEEngine`. One
    instance is one session; its state (slot batch, shared orchestrator)
    is allocated at the first submit (or by ``engine.serve``), and
    :meth:`close` (which ``run`` calls) gives its decode state back to the
    engine. Only one thread may drive ``step()``; ``submit`` and
    ``cancel`` are legal from other threads (the queue is lock-guarded,
    and the lock is never held across a device call).

    ``stats`` counts what the session dispatched: ``chunks``,
    ``decode_steps`` (every step of every chunk), ``waves_batched`` (ragged
    row-local admission prefills of more than one request),
    ``waves_solo`` (solo admission prefills), ``replay_jobs`` (one per
    wave and per chunk), ``replay_s`` (their own summed host seconds, on
    whichever thread ran them), ``replay_blocked_s`` (the dispatch
    thread's seconds in a pipelined submit, blocked while the queue was
    full), and
    ``compiles`` / ``compile_s`` (compiled-chunk keys first met in this
    session — a CUDA graph capture each on the card — and the seconds
    their warm-up and capture took), and ``prefill_compiles`` /
    ``prefill_compile_s`` (the same for the compiled prefill's keys).

    **Failure semantics** (the JAX package's, :mod:`~repro_torch.serving.
    faults` for the taxonomy and the injector): EVERY submitted handle
    resolves — with a result or a typed :class:`ServingError` — and a
    fault takes down only the requests it touched.

      * **Replay fault** (a replay raises — ``replay.prefill``,
        ``replay.chunk``, or the expert cache's ``cache.blob.corrupt``):
        the job's own handles resolve with :class:`ReplayError`; jobs
        queued behind it, or submitted before the next step, skip-fail
        theirs (the ``_replay_epoch`` turns them stale); at the next
        :meth:`step` every still-in-flight request fails with
        ``ReplayError`` too (the shared orchestrator's clock and cache
        died mid-update), the slots are freed, a FRESH orchestrator is
        built and the session replays inline from then on
        (``pipeline=False``). Queued requests serve normally afterwards,
        their modeled numbers from a cold cache; ``health().status`` is
        ``"degraded"``. Which in-flight requests a pipelined fault takes
        down depends on how far the dispatch thread had got when the
        worker failed.
      * **Dispatch fault** (``device.dispatch``): retried with a halved
        chunk down to one step, then with half the live rows deferred per
        retry (frozen for this chunk, dispatched next boundary); a 1-step
        single-row dispatch that still fails resolves THAT slot with
        :class:`DispatchError`. Each rung is a transformation the tokens
        are invariant to. A retry re-dispatches on the caches the failed
        attempt left, which is a clean run only because the ladder's
        errors are raised before the chunk wrote them (``_LADDER_ERRORS``).
      * **Admission fault** (``admit.alloc``): the wave is requeued and
        retried at half size; a single candidate that still fails
        resolves with :class:`AdmissionError`.
      * **Backpressure / shedding**: ``max_queue`` rejects ``submit`` with
        :class:`QueueFull`; queued requests past ``deadline_s`` /
        ``ttft_deadline_s`` are shed with :class:`DeadlineExceeded`
        (``infeasible=True`` when an SLO policy proves the modeled service
        bound no longer fits); in-flight requests past ``deadline_s`` are
        evicted like a cancel (partial result, ``deadline_expired``).
      * **Preemption** (EDF): the weakest in-flight row is evicted for a
        strictly stronger queued head and requeued; it re-prefills on
        resume with identical tokens, and its stream never repeats one.
      * **Pressure degradation** (EDF): the ladder's host-side
        ``DegradeOverride`` rungs change only the modeled accounting.
      * **Close**: replay jobs already submitted run first; every
        still-unresolved handle then resolves with :class:`SessionClosed`.
    """

    def __init__(self, engine, num_slots: Optional[int] = None,
                 scfg: SchedulerConfig = SchedulerConfig(), faults=None):
        self.engine = engine
        self.scfg = scfg
        self._num_slots = num_slots   # None: resolved at start
        self._started = False
        self.closed = False
        self._handles: List[RequestHandle] = []
        self._queue: Deque[RequestHandle] = deque()
        # guards _queue/_handles (and the health counters submitters
        # touch): submit() and cancel() are legal from other threads while
        # ONE thread drives step()
        self._lock = threading.Lock()
        self.stats = dict(chunks=0, decode_steps=0, waves_batched=0,
                          waves_solo=0, replay_jobs=0, replay_s=0.0,
                          replay_blocked_s=0.0,
                          compiles=0, compile_s=0.0, prefill_compiles=0,
                          prefill_compile_s=0.0)
        # fault-tolerance state — lives on the instance from birth so
        # health() is answerable before the session starts
        self._health = SessionHealth()
        self._degraded = False
        self._replay_broken = False  # a replay raised; recovery pending
        self._replay_epoch = 0       # bumps turn queued jobs into no-ops
        self._last_fault: Optional[BaseException] = None
        self._max_queue = scfg.max_queue
        self._faults = faults or getattr(engine, "faults", None) or NO_FAULTS
        # SLO policy layer (FIFO by default: every hook is a no-op)
        self._policy = make_policy(scfg.policy)
        self._pressure_rung = 0
        self._est_cache: dict = {}   # (prompt_len, max_new) -> modeled s

    # --------------------------------------------------------- lifecycle
    def _ensure_started(self, *, num_slots: Optional[int] = None,
                        slots_len: Optional[int] = None,
                        pipeline: Optional[bool] = None,
                        max_queue: Optional[int] = None,
                        policy: Union[str, SchedulingPolicy, None] = None
                        ) -> None:
        if self._started:
            return
        engine, cfg = self.engine, self.engine.cfg
        if max_queue is not None:
            self._max_queue = max_queue
        if policy is not None:
            self._policy = make_policy(policy)
        if pipeline is None:
            pipeline = self.scfg.pipeline
        self._b = max(1, num_slots or self._num_slots or self.scfg.num_slots)
        self._slots_len = slot_bucket(
            slots_len or self.scfg.slots_len or cfg.sliding_window
            or cfg.max_seq_len, cfg.max_seq_len, cfg.sliding_window)
        self._chunk = engine.ecfg.decode_chunk
        self._orch = engine._make_orchestrator()  # ONE shared cache+clock
        self._can_batch = self._can_batch_admissions()
        dev = engine.device
        b = self._b
        # the slots split in blocks over the mesh's data ranks, or whole
        mesh = engine.mesh
        self._dmesh = mesh if (mesh is not None and mesh.data_size > 1
                               and b % mesh.data_size == 0
                               and self._rows_independent()) else None
        self._lo, self._hi = (self._dmesh.batch_block(b) if self._dmesh
                              else (0, b))
        self._states: List[Optional[_SlotState]] = [None] * b
        with engine.lock:
            self._state = engine._decode_batched.acquire(
                self._hi - self._lo, self._slots_len, owner=self)
            self._tok_d = torch.zeros(self._hi - self._lo,
                                      dtype=torch.int32, device=dev)
        self._done = np.ones(b, bool)          # empty slots stay frozen
        self._emitted = np.zeros(b, np.int32)
        self._limits = np.zeros(b, np.int32)
        self._eos = np.full(b, -1, np.int32)
        # per-row sampling state (temperature 0 rows are greedy; the keys
        # of greedy rows are never consumed)
        self._temps = np.zeros(b, np.float32)
        self._topks = np.zeros(b, np.int64)
        self._keys = np.zeros((b, 2), np.int64)
        self._stream = ReplayStream(pipelined=pipeline,
                                    maxsize=self.scfg.max_inflight_chunks)
        self._started = True

    def flush(self) -> None:
        """Block until every submitted replay job has run — every request
        whose device work is complete has been finalized."""
        if self._started:
            self._stream.drain()

    def drain(self, *, cancel_queued: bool = True) -> None:
        """Graceful shutdown: optionally cancel still-queued requests,
        drive :meth:`step` until every in-flight request resolves, then
        :meth:`flush` the replay stream. The session stays open
        (:meth:`close` tears it down)."""
        if not self._started:
            return
        if cancel_queued:
            with self._lock:
                queued = list(self._queue)
            for h in queued:
                h.cancel()
        while self.step():
            pass
        self.flush()

    def close(self) -> None:
        """End the session: replay jobs already submitted run (requests
        whose device work completed finalize normally) and the replay
        worker stops, its decode state goes back to the engine for a
        later session, and EVERY handle still unresolved — queued, in
        flight, or lost to a fault — resolves with a typed
        :class:`SessionClosed`, so no ``result(drive=False)`` /
        ``stream(drive=False)`` waiter is left blocked."""
        if self._started and not self.closed:
            try:
                self._stream.drain()
            except Exception:       # noqa: BLE001 — teardown never blocks
                pass                # on a poisoned stream
            self._stream.close()
            with self.engine.lock:
                self.engine._decode_batched.release(self._state)
            self._state = None
        self.closed = True
        with self._lock:
            self._queue.clear()
            handles = list(self._handles)
        err = SessionClosed(
            "serving session closed before this request resolved")
        for h in handles:
            if not h.done:
                h._finish_error(err)

    def health(self) -> SessionHealth:
        """Snapshot of the session's fault-tolerance state — see
        :class:`~repro_torch.serving.faults.SessionHealth`."""
        status = ("closed" if self.closed
                  else "degraded" if self._degraded else "ok")
        with self._lock:
            depth = len(self._queue)
        return dataclasses.replace(
            self._health, status=status, queue_depth=depth,
            in_flight=(sum(s is not None for s in self._states)
                       if self._started else 0))

    def __enter__(self) -> "ContinuousBatchingScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ submit
    def submit(self, request: Request, rng_key=None) -> RequestHandle:
        """Queue one request for admission at the next chunk boundary and
        return its :class:`RequestHandle`; legal at any point of the
        session and from any thread. Its PRNG stream root is ``rng_key``
        if given, else ``PRNGKey(request.seed)``; ``temperature > 0`` with
        neither falls back to greedy with a warning. Over ``max_queue``
        it raises :class:`QueueFull` and creates no handle; a closed
        session raises :class:`SessionClosed`."""
        if self.closed:
            raise SessionClosed("serving session is closed")
        self._ensure_started()
        need = request.prompt_len + request.max_new_tokens
        if self.engine.cfg.sliding_window is None and need > self._slots_len:
            raise ValueError(
                f"request needs {need} cache slots (prompt "
                f"{request.prompt_len} + max_new {request.max_new_tokens}) "
                f"but the session's slot budget is {self._slots_len}; open "
                f"the session with a larger slots_len")
        # ONE lock section: the queue bound, the index -> request_id
        # assignment and the append must agree under concurrent submitters
        with self._lock:
            if self._max_queue is not None and \
                    len(self._queue) >= self._max_queue:
                self._health.queue_rejections += 1
                raise QueueFull(
                    f"admission queue is full ({self._max_queue} queued); "
                    "retry later (faults.submit_with_retry) or open the "
                    "session with a larger max_queue")
            h = RequestHandle(self, len(self._handles), request,
                              self._now())
            temp, top_k, key = resolve_sampling(request, rng_key,
                                                context=h.request_id)
            h.temperature, h.top_k = float(temp), int(top_k)
            h.key = raw_key_data(key) if key is not None else None
            self._handles.append(h)
            self._queue.append(h)
            self._health.submitted += 1
        return h

    def _note_completed(self) -> None:
        """Handle-finalizer callback: the monotonic ``completed`` counter,
        once per resolved handle."""
        with self._lock:
            self._health.completed += 1

    # -------------------------------------------------------------- SPMD
    @property
    def spmd(self) -> bool:
        """Whether the engine is one rank of a mesh of several: every rank
        runs this session, and must take every host decision alike (the
        collectives of the device work it drives pair up only then)."""
        return self.engine.eager

    def _now(self) -> float:
        """The clock for a host decision (submission, shedding, eviction,
        pressure, preemption, admission order): under SPMD rank 0's
        reading, broadcast, so that every rank decides alike."""
        now = time.perf_counter()
        if self.spmd:
            now = self.engine.mesh.agree_float(now)
        return now

    def _cancelled(self) -> set:
        """Indices of the queued and in-flight handles whose cancellation
        this boundary honours. Under SPMD rank 0's set, broadcast: a
        ``cancel`` may land on the ranks at different boundaries (it is a
        no-op on a handle whose replay already finalized it)."""
        with self._lock:
            hs = list(self._queue)
        hs += [st.handle for st in self._states if st is not None]
        if not hs:
            return set()
        got = {h.index for h in hs if h.cancel_requested}
        if self.spmd:
            got = set(self.engine.mesh.broadcast_object(sorted(got)))
        return got

    def _rows_independent(self) -> bool:
        """Whether every device program of the session computes each row
        on its own: DyMoE's per-row MoE paths and non-MoE blocks. A
        full-precision MoE runs its rows as one batch of global capacity
        (the reference's), so its session is replicated over data."""
        eng = self.engine
        return not eng.cfg.is_moe or (eng.qparams is not None
                                      and eng.cfg.dymoe.enabled)

    def _owns(self, slot: int) -> bool:
        """Whether ``slot`` is in this rank's block of the slots."""
        return self._lo <= slot < self._hi

    def _row_bytes(self, tensors) -> torch.Tensor:
        """(rows, bytes) uint8: each row's values of ``tensors`` (leading
        dim the rows; None skipped), as bytes side by side — the payload
        of one exact gather over "data"."""
        return torch.cat([t.contiguous().reshape(t.shape[0], -1)
                          .view(torch.uint8) for t in tensors
                          if t is not None], dim=1)

    @staticmethod
    def _unpack(buf: np.ndarray, layout):
        """The host arrays of :meth:`_row_bytes`'s rows ``buf`` (n, bytes):
        ``layout`` lists (dtype, per-row shape) in order (None: a None
        leaf). Each comes back (n, *shape)."""
        out, off = [], 0
        for item in layout:
            if item is None:
                out.append(None)
                continue
            dtype, shape = item
            w = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            out.append(np.ascontiguousarray(buf[:, off:off + w]).view(dtype)
                       .reshape((buf.shape[0],) + tuple(shape)))
            off += w
        return out

    def _tele_layout(self, steps: Optional[int]):
        """Per-row (dtype, shape) of the Critical / active masks and the
        look-ahead (``steps`` None: a prefill's (L, E)); None leaves for a
        non-MoE config."""
        cfg = self.engine.cfg
        if not cfg.is_moe:
            return [None] * 3
        shape = ((cfg.num_layers, cfg.num_experts) if steps is None
                 else (steps, cfg.num_layers, cfg.num_experts))
        return [(np.bool_, shape), (np.bool_, shape), (np.float32, shape)]

    # -------------------------------------------------------------- step
    def step(self) -> bool:
        """Advance ONE chunk boundary: finish a replay-fault recovery,
        shed expired (or infeasible) queued requests, free the slots of
        cancelled and expired rows, update the pressure rung, preempt at
        most once, admit into free slots, then dispatch one decode chunk
        if any row is live. Returns False when idle."""
        if self.closed:
            raise SessionClosed("serving session is closed")
        if not self._started:
            return False
        progress = self._recover_replay()
        progress |= self._shed_expired()
        progress |= self._sweep_cancelled()
        self._update_pressure()
        progress |= self._preempt_boundary()
        progress |= self._admit_boundary()
        if self._done.all():
            return progress
        self._dispatch_chunk()
        return True

    def _shed_expired(self) -> bool:
        """Shed queued requests whose ``deadline_s`` / ``ttft_deadline_s``
        (from submission) has expired with :class:`DeadlineExceeded`;
        under a policy that ``sheds_infeasible``, also those whose
        optimistic modeled service bound no longer fits their remaining
        budget (``infeasible=True``)."""
        pol = self._policy
        with self._lock:
            if not self._queue:
                return False
        now = self._now()
        shed: List[RequestHandle] = []
        infeasible: List[RequestHandle] = []
        with self._lock:
            keep: Deque[RequestHandle] = deque()
            for h in self._queue:
                r = h.request
                waited = now - h.submit_t
                if (r.deadline_s is not None and waited > r.deadline_s) \
                        or (r.ttft_deadline_s is not None
                            and waited > r.ttft_deadline_s):
                    shed.append(h)
                elif pol.sheds_infeasible and pol.infeasible(
                        h, now, self._service_estimate(r)):
                    infeasible.append(h)
                else:
                    keep.append(h)
            if not shed and not infeasible:
                return False
            self._queue = keep
            self._health.deadline_shed += len(shed)
            self._health.infeasible_shed += len(infeasible)
        for h in shed:
            req = h.request
            h._finish_error(DeadlineExceeded(
                f"{h.request_id}: shed after {now - h.submit_t:.3f}s in "
                f"queue (deadline_s={req.deadline_s}, "
                f"ttft_deadline_s={req.ttft_deadline_s})"))
        for h in infeasible:
            req = h.request
            h._finish_error(DeadlineExceeded(
                f"{h.request_id}: provably infeasible — modeled service "
                f"bound {self._service_estimate(req):.4f}s exceeds the "
                f"remaining deadline budget after {now - h.submit_t:.3f}s "
                f"queued (deadline_s={req.deadline_s}, "
                f"ttft_deadline_s={req.ttft_deadline_s})",
                infeasible=True))
        return True

    def _service_estimate(self, request: Request) -> float:
        """Optimistic modeled service bound for one request (policy
        feasibility input), cached per (prompt_len, max_new_tokens)."""
        fn = getattr(self._policy, "service_estimate_fn", None)
        if fn is not None:
            return float(fn(request))
        key = (request.prompt_len, request.max_new_tokens)
        est = self._est_cache.get(key)
        if est is None:
            est = self._est_cache[key] = estimate_service_s(
                self.engine.cost, self.engine.cfg, request)
        return est

    def _update_pressure(self) -> None:
        """Re-evaluate the SLO pressure ladder (a no-op for policies
        without one, FIFO included). A rung change installs the rung's
        host-side ``DegradeOverride`` on the shared orchestrator at this
        boundary, ordered with the replays (site ``degrade.shift``: a
        fault skips the shift)."""
        pol = self._policy
        if pol.ladder is None or self._orch is None:
            return
        now = self._now()
        with self._lock:
            queued = list(self._queue)
        states = [st for st in self._states if st is not None]
        headrooms = [
            h.submit_t + b - now
            for h in queued
            if (b := effective_deadline(h.request)) != float("inf")
        ] + [
            st.handle.submit_t + b - now
            for st in states
            if (b := effective_deadline(st.request)) != float("inf")
        ]
        pressure = SLOPressure(
            queue_depth=len(queued), in_flight=len(states), slots=self._b,
            min_headroom_s=min(headrooms) if headrooms else None,
            mean_headroom_s=(sum(headrooms) / len(headrooms)
                             if headrooms else None))
        rung = pol.rung_for(pressure, self._pressure_rung)
        if rung == self._pressure_rung:
            return
        try:
            self._faults.fire("degrade.shift",
                              from_rung=self._pressure_rung, to_rung=rung)
        except InjectedFault as e:
            # a faulted shift is SKIPPED: the session stays at its rung
            self._health.last_fault = repr(e)
            self._last_fault = e
            return
        self._pressure_rung = rung
        self._health.pressure_rung = rung
        self._health.rung_transitions += 1
        # rides the replay stream, so it lands in serial order between the
        # replays; epoch-guarded like every job: after a replay fault the
        # stale install is skipped and _recover_replay installs the
        # current rung on the fresh orchestrator
        self._submit_replay(partial(self._orch.set_degrade,
                                    pol.ladder.override_for(rung)), [])

    def _preempt_boundary(self) -> bool:
        """At most ONE preemption per step, under a preemptive policy with
        every slot busy: the policy's victim row is evicted (slot freed,
        device row frozen, its replayed telemetry kept) and its handle
        requeued at the queue front; the freed slot goes to this
        boundary's admission (site ``preempt.evict``: a fault aborts the
        preemption)."""
        pol = self._policy
        if not pol.preemptive:
            return False
        in_flight = [(r, st) for r, st in enumerate(self._states)
                     if st is not None]
        free = any(self._done[r] and self._states[r] is None
                   for r in range(self._b))
        with self._lock:
            queued = list(self._queue)
        if free or not queued or not in_flight:
            return False
        decision = pol.preempt(queued, in_flight, self._now())
        if decision is None:
            return False
        head, (r, st) = decision
        try:
            self._faults.fire("preempt.evict", slot=r,
                              victim=st.handle.request_id,
                              urgent=head.request_id)
        except InjectedFault as e:
            self._health.last_fault = repr(e)
            self._last_fault = e
            return False
        self._states[r] = None
        self._done[r] = True     # device row freezes from now on
        st.handle._preempted += 1
        self._health.preemptions += 1
        with self._lock:
            self._queue.appendleft(st.handle)
        return True

    def _sweep_cancelled(self) -> bool:
        """Drop cancelled requests from the queue (an empty cancelled
        result each) and free the slots of cancelled rows and of rows past
        ``deadline_s`` (their partial results, ``cancelled``)."""
        progress = False
        dropped: List[RequestHandle] = []
        cancelled = self._cancelled()
        with self._lock:
            if any(h.index in cancelled for h in self._queue):
                keep: Deque[RequestHandle] = deque()
                for h in self._queue:
                    (dropped if h.index in cancelled else keep).append(h)
                self._queue = keep
        for h in dropped:   # finalize outside the lock
            self._submit_replay(partial(self._finalize_unadmitted, h), [h])
            progress = True
        if all(st is None for st in self._states):
            return progress
        now = self._now()
        for r in range(self._b):
            st = self._states[r]
            if st is None:
                continue
            dl = st.request.deadline_s
            expired = dl is not None and now - st.handle.submit_t > dl
            if st.handle.index in cancelled or expired:
                self._states[r] = None   # freed for the admission below
                self._done[r] = True     # device row freezes from now on
                if expired and st.handle.index not in cancelled:
                    self._health.deadline_evictions += 1
                self._submit_replay(
                    partial(self._finalize, st, cancelled=True,
                            deadline_expired=expired), [st.handle])
                progress = True
        return progress

    # --------------------------------------------------------- admission
    def _admit_boundary(self) -> bool:
        """Fill every free slot from the queue (in the policy's order). Up
        to ``len(free)`` queued requests prefill together in one wave (one
        host sync for their first tokens); requests that finish at their
        first token free their claim at once, so further waves run until
        the slots are full or the queue drains. A failed wave (site
        ``admit.alloc``) is requeued and retried at half size; a single
        candidate that still fails resolves with :class:`AdmissionError`.
        Survivors claim free slots in pop order, and each wave's rows are
        injected before the next wave's prefill overwrites its caches."""
        engine = self.engine
        free = [r for r in range(self._b)
                if self._done[r] and self._states[r] is None]
        if not free or not self._queue:
            return False
        if self._policy.reorders:
            now0 = self._now()
            with self._lock:
                if len(self._queue) > 1:
                    self._queue = deque(
                        self._policy.order(list(self._queue), now0))
        n_survivors = 0
        cap: Optional[int] = None   # ladder: bound on a retried wave size
        while n_survivors < len(free) and self._queue:
            room = len(free) - n_survivors
            if cap is not None:
                room = min(room, cap)
            if not self._can_batch:
                room = 1     # one exact-shape solo prefill per request
            cands: List[RequestHandle] = []
            with self._lock:
                while self._queue and len(cands) < room:
                    cands.append(self._queue.popleft())
            now = self._now()
            lens = [h.request.prompt_len for h in cands]
            n = len(cands)
            # the engine's lock from the prefill through the injection of
            # its rows: the prefill's outputs are fixed buffers that any
            # other session's next prefill on this engine overwrites
            with engine.lock:
                wave = self._admit_wave(cands, lens, now, free, n_survivors)
            if wave is None:                   # failed: requeued or resolved
                cap = max(1, n // 2) if n > 1 else cap
                continue
            cap = None   # a clean wave resets the ladder
            wave_states, tele, n_new = wave
            n_survivors += n_new
            self._timed(self._replay_prefill, [h for h in cands],
                        wave_states, tele, n > 1)
        return True

    def _admit_wave(self, cands: List[RequestHandle], lens: List[int],
                    now: float, free: List[int], n_survivors: int):
        """One admission wave's device work, under the engine's lock: its
        prefill, the ONE host sync for its first tokens, and the injection
        of its survivors into the next free slots (pop order). Returns
        (the wave's slot states, its telemetry, the slots it took), or
        None when the prefill failed: a wave of several candidates is
        requeued (the ladder retries it at half size), a single candidate
        resolves with :class:`AdmissionError`."""
        engine = self.engine
        n = len(cands)
        compiled = engine._prefill
        n_comp, comp_s = compiled.compiles, compiled.compile_s
        # the candidates this rank prefills: all, or (slots split over
        # data) those whose slot, were every candidate to survive, is in
        # its block
        mine = list(range(n)) if self._dmesh is None else [
            i for i in range(n) if self._owns(free[n_survivors + i])]
        try:
            self._faults.fire("admit.alloc", n=n)
            out = self._prefill_wave(cands, lens, mine)
            first, tele = self._first_tokens(out, cands, mine)
        except _LADDER_ERRORS as e:
            self._last_fault = e
            self._health.last_fault = repr(e)
            if n > 1:
                with self._lock:
                    for h in reversed(cands):
                        self._queue.appendleft(h)
                self._health.admission_retries += 1
                return None
            self._health.admission_failures += 1
            err = AdmissionError(
                f"{cands[0].request_id}: admission prefill failed "
                f"even as a solo wave ({e!r})")
            err.__cause__ = e
            cands[0]._finish_error(err)
            return None
        finally:
            self.stats["prefill_compiles"] += compiled.compiles - n_comp
            self.stats["prefill_compile_s"] += compiled.compile_s - comp_s
        self.stats["waves_batched" if n > 1 else "waves_solo"] += 1
        t_dec = time.perf_counter()
        wave_states, src, toks, surv = [], [], [], []
        for i, h in enumerate(cands):
            req = h.request
            ft = int(first[i])
            st = _SlotState(
                handle=h, request=req, tokens=[ft], prompt_len=lens[i],
                admit_t=now, queue_wait_s=now - h.submit_t,
                finish_now=(req.max_new_tokens <= 1
                            or (req.eos_token is not None
                                and ft == req.eos_token)),
                decode_t0=t_dec, end_t=t_dec)
            wave_states.append(st)
            if not st.finish_now:
                src.append(i)
                toks.append(ft)
                surv.append(st)
        if not src:
            return wave_states, tele, 0
        # the survivors claim the next free slots (pop order); their rows
        # go in now, before the next prefill overwrites out
        dst = free[n_survivors:n_survivors + len(src)]
        for st, r in zip(surv, dst):
            h = st.handle
            self._states[r] = st
            self._done[r] = False
            self._emitted[r] = 1
            self._limits[r] = st.request.max_new_tokens
            self._eos[r] = (-1 if st.request.eos_token is None
                            else st.request.eos_token)
            self._temps[r] = h.temperature
            self._topks[r] = h.top_k
            self._keys[r] = h.key if h.key is not None else 0
        # the rows whose slot is in this rank's block: from its own
        # prefill, or (a survivor moved across a block edge by a candidate
        # that finished at its first token) prefilled again here
        lo = self._lo
        keep = [(mine.index(i), r - lo, t) for i, r, t in zip(src, dst, toks)
                if self._owns(r) and i in mine]
        moved = [(i, r - lo, t) for i, r, t in zip(src, dst, toks)
                 if self._owns(r) and i not in mine]
        self._inject(out, keep)
        if moved:
            self._inject(self._prefill_wave(cands, lens,
                                            [i for i, _, _ in moved]),
                         [(j, r, t) for j, (_, r, t) in enumerate(moved)])
        return wave_states, tele, len(src)

    def _inject(self, out, rows) -> None:
        """Rows (wave row, local slot, first token) of a wave's prefill
        ``out`` into this rank's slots."""
        if not rows:
            return
        dev = self.engine.device
        src, dst, toks = (np.asarray(c) for c in zip(*rows))
        dst_d = _h2d(dst.astype(np.int64), dev)
        self._inject_rows(out.caches, _h2d(src.astype(np.int64), dev),
                          dst_d)
        self._tok_d[dst_d] = _h2d(toks.astype(np.int32), dev)

    def _first_tokens(self, out, cands: List[RequestHandle],
                      mine: List[int]):
        """The wave's ONE host sync: every candidate's first token (host
        (n,)) and the wave's telemetry (host tensors, (L, n, E) for a
        batched wave, (L, E) for a solo one). Sampled candidates draw with
        fold count 0 through the per-row sampler (greedy rows take the
        same argmax). With the slots split over data, this rank's rows
        (``mine``; ``out`` None when it has none) go into one exact gather
        over "data" with their telemetry, and the fetch follows it."""
        dev = self.engine.device
        first_d = tele_d = None
        if out is not None:
            hs = [cands[i] for i in mine]
            info = out.info
            tele_d = (info.critical_masks, info.active_masks,
                      info.predicted_next)
            if any(h.temperature > 0.0 for h in hs):
                keys = np.zeros((len(hs), 2), np.int64)
                for i, h in enumerate(hs):
                    if h.key is not None:
                        keys[i] = h.key
                first_d = sample_token_rows(
                    out.logits, fold_in(_h2d(keys, dev), 0),
                    _h2d(np.asarray([h.temperature for h in hs],
                                    np.float32), dev),
                    _h2d(np.asarray([h.top_k for h in hs],
                                    np.int64), dev))
            else:
                first_d = torch.argmax(out.logits, dim=-1)
        if self._dmesh is None:
            tele = _d2h_async(tele_d)
            return first_d.cpu().numpy(), tele
        n = len(cands)
        layout = [(np.int64, ())] + self._tele_layout(None)
        if out is not None:
            # (L, k, E) leaves, or a solo prefill's (L, E): rows first
            rows = [None if x is None else
                    (x[:, None] if n == 1 else x).transpose(0, 1)
                    for x in tele_d]
            payload = self._row_bytes([first_d.to(torch.int64)] + rows)
        else:
            width = sum(int(np.prod(sh, dtype=np.int64))
                        * np.dtype(dt).itemsize
                        for dt, sh in filter(None, layout))
            payload = torch.zeros((0, width), dtype=torch.uint8, device=dev)
        whole = self._dmesh.all_gather_rows(payload, mine, n)
        first, *leaves = self._unpack(whole.cpu().numpy(), layout)
        tele = tuple(None if x is None else torch.from_numpy(
            x[0] if n == 1 else np.ascontiguousarray(x.swapaxes(0, 1)))
            for x in leaves)
        return first, tele

    def _slot_budget(self, requests: Sequence[Request]) -> int:
        """The cache slots :meth:`run` asks for: the sliding window, whose
        ring serves any length, else the longest prompt plus its new
        tokens."""
        cfg = self.engine.cfg
        if cfg.sliding_window:
            return cfg.sliding_window
        return max(r.prompt_len + r.max_new_tokens for r in requests)

    def _can_batch_admissions(self) -> bool:
        """A ragged batched admission prefill needs the right-aligned
        ragged machinery: attention archs without a shared-attention site
        (an SSM scan would thread pads through its state). Everything else
        admits one request per prefill, the exact solo program; so does a
        config with a sliding window (a ragged prefill into a ring cache
        is refused, as in the reference)."""
        cfg = self.engine.cfg
        return (cfg.block_kinds()[0] in ("attn_dense", "attn_moe")
                and not cfg.shared_attn_every
                and cfg.sliding_window is None)

    def _prefill_wave(self, cands: List[RequestHandle], lens: List[int],
                      rows: List[int]):
        """One admission wave's prefill of candidates ``rows`` (all of
        them, or this data rank's) through the engine's compiled prefill
        (its key: the wave's shape, the session's ``slots_len``, row-local
        or not): a ragged right-aligned row-local prefill for a wave of
        more than one candidate, padded to the wave's own longest prompt;
        the exact solo prefill for a wave of one. None when ``rows`` is
        empty. Writes only the compiled prefill's own outputs, which the
        next prefill overwrites."""
        engine, cfg = self.engine, self.engine.cfg
        if not rows:
            return None
        if len(cands) > 1:
            smax = max(lens)
            prompts = np.zeros((len(rows), smax), np.int64)
            for j, i in enumerate(rows):   # right-aligned
                prompts[j, smax - lens[i]:] = cands[i].request.prompt_tokens
            sub = [lens[i] for i in rows]
            return engine._prefill(
                prompts, cache_slots=self._slots_len,
                lengths=np.asarray(sub, np.int32), row_local=True,
                # parity trap — capacities: exact host-side solo values
                row_capacities=np.asarray(
                    [_capacity(cfg, s) for s in sub], np.int64)
                if cfg.is_moe else None)
        prompt = np.asarray(cands[0].request.prompt_tokens,
                            np.int64)[None, :]
        return engine._prefill(prompt, cache_slots=self._slots_len)

    def _inject_rows(self, rc: dict, src: torch.Tensor,
                     dst: torch.Tensor) -> None:
        """Overwrite slots ``dst`` of the batch caches with rows ``src`` of
        a freshly prefilled wave's caches (``"layers"`` and, for the
        hybrid, ``"shared"``; leaves (L or sites, B, ...)). An SSM state
        is copied as it is. A ragged wave prefills right-aligned, so row
        i's KV window sits at slot offset ``S_wave - s_i``; each KV row is
        LEFT-ALIGNED here (window rolled to offset 0, emptied slots
        zeroed), making the injected row identical to a solo admission of
        the same request, layout included."""
        for part, c in rc.items():
            bc = self._state.caches[part]
            if isinstance(c, SSMCache):
                for f in ("conv_state", "ssm_state", "length"):
                    getattr(bc, f)[:, dst] = getattr(c, f)[:, src]
                continue
            pos = c.positions[:, src]                      # (L, n, S)
            off = c.offset[:, src].to(torch.int64)         # (L, n)
            s = pos.shape[-1]
            # jnp.roll(x, -off): new[j] = old[(j + off) % S]
            gidx = (torch.arange(s, device=pos.device)[None, None, :]
                    + off[..., None]) % s                  # (L, n, S)
            p2 = torch.gather(pos, 2, gidx)
            live = (p2 >= 0)[:, :, None, :, None]          # (L, n, 1, S, 1)
            for name in ("k", "v"):
                t = getattr(c, name)[:, src]               # (L, n, H, S, D)
                g = gidx[:, :, None, :, None].expand(t.shape)
                rolled = torch.gather(t, 3, g)
                getattr(bc, name)[:, dst] = torch.where(
                    live, rolled, torch.zeros((), dtype=t.dtype,
                                              device=t.device))
            bc.positions[:, dst] = p2
            bc.length[:, dst] = c.length[:, src]
            bc.offset[:, dst] = torch.zeros((), dtype=bc.offset.dtype,
                                            device=bc.offset.device)

    # ---------------------------------------------------------- dispatch
    def _dispatch_chunk(self) -> None:
        """One decode chunk over every slot; dead rows are frozen on the
        device and cost no MoE slots. ``live_cap`` sizes each MoE
        precision region to the live-row count, rounded up to a power of
        two. A chunk with no live sampled row runs the greedy argmax (no
        vocabulary sort). The chunk's only host sync is the fetch, at its
        end, of the done/emitted masks together with its tokens — outside
        the retry ladder (site ``device.dispatch``; see the class
        docstring), so an error surfacing there propagates."""
        emitted_before = self._emitted.copy()
        deferred = np.zeros(self._b, bool)
        # the engine's lock from the dispatch through the readout: the
        # chunk's outputs are fixed buffers any next call overwrites
        with self.engine.lock:
            got = self._run_chunk(deferred)
        if got is None:
            return   # everything deferred/failed; retry next step
        chunk, tele, host = got
        new_done = host[0].astype(bool)
        new_emitted = host[1].astype(np.int32)
        # deferred rows were frozen for THIS dispatch only: their host
        # masks stay, so they dispatch again at the next boundary
        new_done[deferred] = self._done[deferred]
        new_emitted[deferred] = self._emitted[deferred]
        self._done, self._emitted = new_done, new_emitted
        t_sync = time.perf_counter()
        self.stats["chunks"] += 1
        self.stats["decode_steps"] += chunk
        rows = []
        for r in range(self._b):
            st = self._states[r]
            if st is None or deferred[r]:
                continue
            st.end_t = t_sync
            rows.append((r, st, int(self._emitted[r] - emitted_before[r]),
                         st.prompt_len + int(emitted_before[r]),
                         bool(self._done[r])))
            if self._done[r]:
                self._states[r] = None  # evict: free to admit; the replay
                #                         below finalizes st
        self._timed(self._replay_chunk, [st.handle for _, st, *_ in rows],
                    host[2:2 + chunk], tele, rows)

    def _run_chunk(self, deferred: np.ndarray):
        """The chunk's device work, under the engine's lock: the dispatch
        and its retry ladder (``deferred`` marks the rows it froze for
        this dispatch), then the copies the session keeps and the boundary
        sync. Returns (the chunk's length, its telemetry's host copies,
        the fetched done / emitted / token rows), or None when no row
        could run."""
        compiled = self.engine._decode_batched
        chunk = self._chunk          # transient: self._chunk is untouched
        lo, hi = self._lo, self._hi  # this rank's block of the slots
        while True:
            live = [r for r in range(self._b)
                    if not self._done[r] and not deferred[r]]
            if not live:
                return None
            done_in = self._done | deferred
            sample_kw = {}
            if (self._temps[~done_in] > 0.0).any():
                sample_kw = dict(rng_keys=self._keys[lo:hi],
                                 temperatures=self._temps[lo:hi],
                                 top_ks=self._topks[lo:hi])
            n_live = sum(self._owns(r) for r in live)
            n_comp, comp_s = compiled.compiles, compiled.compile_s
            try:
                self._faults.fire("device.dispatch",
                                  chunk=self.stats["chunks"],
                                  num_steps=chunk, rows=len(live))
                out = compiled(
                    self._state, self._tok_d, num_steps=chunk,
                    done=done_in[lo:hi], n_emitted=self._emitted[lo:hi],
                    limits=self._limits[lo:hi], eos_tokens=self._eos[lo:hi],
                    live_cap=live_cap_for(n_live, hi - lo), **sample_kw)
                break
            except _LADDER_ERRORS as e:
                self._health.dispatch_retries += 1
                self._health.last_fault = repr(e)
                self._last_fault = e
                if chunk > 1:
                    chunk //= 2          # token-exact: chunk invariance
                    continue
                if len(live) > 1:        # token-exact: slot invariance
                    deferred[live[len(live) // 2:]] = True
                    continue
                # a 1-step single-row dispatch still failing: fail THAT
                # slot with a typed error; everyone else keeps serving
                r = live[0]
                st = self._states[r]
                self._states[r] = None
                self._done[r] = True
                self._health.dispatch_failures += 1
                err = DispatchError(
                    f"{st.handle.request_id}: device decode dispatch kept "
                    f"failing down to a 1-step solo chunk ({e!r})")
                err.__cause__ = e
                st.handle._finish_error(err)
            finally:
                self.stats["compiles"] += compiled.compiles - n_comp
                self.stats["compile_s"] += compiled.compile_s - comp_s
        # the outputs are fixed buffers the next chunk overwrites: copy
        # what the session keeps, on the stream, before that
        self._tok_d.copy_(out.tokens[-1])
        info = out.info
        tele_d = (info.critical_masks, info.active_masks, info.predicted_next)
        rows = torch.cat([out.done.to(torch.int32)[None],
                          out.n_emitted.to(torch.int32)[None],
                          out.tokens.to(torch.int32)])    # (2 + T, B)
        if self._dmesh is None:
            tele = _d2h_async(tele_d)
            return chunk, tele, rows.cpu().numpy()        # the boundary sync
        # slots split over data: this rank's rows, with their telemetry,
        # into ONE exact gather over "data", then the boundary sync
        whole = self._dmesh.all_gather(self._row_bytes(
            [rows.T] + [None if x is None else x.permute(2, 0, 1, 3)
                        for x in tele_d]), 0, axis="data")
        host, *leaves = self._unpack(
            whole.cpu().numpy(),
            [(np.int32, (2 + chunk,))] + self._tele_layout(chunk))
        return chunk, tuple(
            None if x is None else torch.from_numpy(
                np.ascontiguousarray(x.transpose(1, 2, 0, 3)))
            for x in leaves), np.ascontiguousarray(host.T)

    # ------------------------------------------- replay fault tolerance
    def _timed(self, replay, handles, *args) -> None:
        """Submit one telemetry replay (a wave's or a chunk's), counted;
        its own seconds are added where it runs, and the seconds a
        pipelined submit blocked on a full queue apart from them."""
        t0 = time.perf_counter()
        self._submit_replay(partial(replay, *args), handles, timed=True)
        self.stats["replay_jobs"] += 1
        if self._stream.pipelined:
            self.stats["replay_blocked_s"] += time.perf_counter() - t0

    def _submit_replay(self, fn, handles, timed: bool = False) -> None:
        """Submit one replay job to the stream, WRAPPED so a failure can
        never poison it: a job that raises resolves its OWN handles (those
        ``fn`` would have finalized) with a typed :class:`ReplayError` and
        marks the session for recovery instead."""
        self._stream.submit(partial(self._run_replay, self._replay_epoch,
                                    fn, handles, timed))

    def _run_replay(self, epoch, fn, handles, timed) -> None:
        # the replay stream's context (its worker thread when pipelined)
        if self._replay_broken or epoch != self._replay_epoch:
            # a job from before a replay fault: its telemetry would replay
            # against a clock and cache that died mid-update — skip-fail
            # its requests instead of running it
            err = self._replay_error()
            for h in handles:
                h._finish_error(err)
            return
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as exc:   # noqa: BLE001 — translated to typed
            self._on_replay_failure(exc, handles)
        finally:
            if timed:
                self.stats["replay_s"] += time.perf_counter() - t0

    def _replay_error(self) -> ReplayError:
        return ReplayError(
            "telemetry replay failed while this request was in flight; "
            "its device tokens may exist but its modeled accounting is "
            f"lost (cause: {self._last_fault!r})")

    def _on_replay_failure(self, exc: BaseException, handles) -> None:
        # the replay's half of a fault; _recover_replay (the driving
        # thread, next step()) completes it
        with self._lock:
            self._last_fault = exc
            self._replay_broken = True
            self._replay_epoch += 1   # queued jobs become stale no-ops
            self._degraded = True
            self._health.replay_faults += 1
            self._health.last_fault = repr(exc)
        err = self._replay_error()
        err.__cause__ = exc
        for h in handles:
            h._finish_error(err)

    def _recover_replay(self) -> bool:
        """The driving thread's half of a replay-fault recovery, at the top
        of the next :meth:`step`: every in-flight request fails with
        :class:`ReplayError` and its slot is freed, a FRESH orchestrator
        (at the current pressure rung) replaces the broken one, and the
        session replays inline from then on (``pipeline=False``): the old
        worker skip-fails the stale jobs it still holds, then stops.
        Queued requests are untouched."""
        if not self._replay_broken:
            return False
        err = self._replay_error()
        progress = False
        for r in range(self._b):
            st = self._states[r]
            if st is not None:
                st.handle._finish_error(err)   # idempotent: the worker
                #                                may have failed it first
                self._states[r] = None
                self._done[r] = True
                progress = True
        self._orch = self.engine._make_orchestrator()  # fresh clock+cache
        if self._orch is not None and self._policy.ladder is not None:
            # a queued set_degrade died with the old stream (stale
            # epoch): put the fresh orchestrator on the CURRENT rung
            self._orch.set_degrade(
                self._policy.ladder.override_for(self._pressure_rung))
        old = self._stream
        with self._lock:
            # bump AGAIN: whatever was submitted between the fault and now
            # is stale, so the old worker drains it without touching the
            # fresh orchestrator
            self._replay_epoch += 1
            self._replay_broken = False
        self._stream = ReplayStream(pipelined=False)   # inline from now on
        old.close()   # fast: stale jobs skip-fail, then the worker exits
        return progress

    # ------------------------------------------------------------ replay
    def _emit(self, st: _SlotState, phase: str, tokens: List[int],
              modeled_s: float, tok_start: int) -> None:
        """Push one TokenChunk stream event, suppressing tokens a
        pre-preemption incarnation of this handle already delivered
        (``tok_start`` is the index of ``tokens[0]`` in the request's
        output; tokens are identical across incarnations)."""
        h = st.handle
        end = tok_start + len(tokens)
        new = tokens[max(0, h._streamed - tok_start):]
        if not new:
            return   # fully delivered already (resumed prefix replay)
        h._push_event(TokenChunk(request_id=h.request_id, phase=phase,
                                 tokens=new, modeled_s=modeled_s))
        h._streamed = max(h._streamed, end)

    def _finalize(self, st: _SlotState, *, cancelled: bool = False,
                  deadline_expired: bool = False) -> None:
        # st's last telemetry has been replayed. ``cancelled`` comes from
        # the PATH that finalized (the sweep), not the handle's flag: a
        # cancel() racing a natural completion must not mislabel it
        from repro_torch.serving.engine import GenerationResult

        orch = self._orch
        n_dec = max(len(st.tokens) - 1, 1)
        st.handle._finish(GenerationResult(
            tokens=st.tokens,
            ttft_s=float(st.ttft_s),
            tpot_s=float(sum(st.step_totals) / n_dec),
            wall_s=st.end_t - st.admit_t,
            queue_wait_s=st.queue_wait_s,
            decode_wall_s=st.end_t - st.decode_t0,
            prefill_timing=st.prefill_timing,
            decode_timings=st.decode_timings or None,
            cache_stats=(dataclasses.asdict(orch.cache.stats)
                         if orch else None),
            prefill_weight_bytes=st.prefill_weight_bytes if orch else None,
            decode_weight_bytes_per_tok=(
                st.decode_weight_bytes / n_dec
                if st.decode_timings else None),
            cancelled=cancelled, deadline_expired=deadline_expired,
            preempted=st.handle._preempted))

    def _finalize_unadmitted(self, h: RequestHandle) -> None:
        """A request cancelled while still queued: nothing ran for it."""
        from repro_torch.serving.engine import GenerationResult

        h._finish(GenerationResult(
            tokens=[], ttft_s=float("nan"), tpot_s=float("nan"),
            wall_s=0.0, queue_wait_s=time.perf_counter() - h.submit_t,
            cancelled=True))

    def _replay_prefill(self, wave: List[_SlotState], tele, per_row: bool
                        ) -> None:
        """Replay one admission wave's prefill telemetry, candidate by
        candidate in pop order (the serial admission order), emit each
        candidate's prefill event, and finalize the one-token requests."""
        self._faults.fire("replay.prefill", n=len(wave))
        crit, act, pred = _numpy(tele)
        for i, st in enumerate(wave):
            if crit is None:    # a non-MoE config: no telemetry
                c = a = p = None
            elif per_row:       # (L, B, E) row-local leaves -> this row
                c, a, p = crit[:, i], act[:, i], pred[:, i]
            else:               # solo admission: (L, E) leaves, B == 1
                c, a, p = crit, act, pred
            timings, totals, wbytes = self.engine._replay(
                c, a, p, phase="prefill",
                s_ctx=np.asarray([st.prompt_len]), s_q=st.prompt_len,
                orch=self._orch)
            st.ttft_s = timings[0].total_s if timings else totals[0]
            st.prefill_timing = timings[0] if timings else None
            st.prefill_weight_bytes = wbytes
            self._emit(st, "prefill", [st.tokens[0]], float(st.ttft_s), 0)
            if st.finish_now:
                self._finalize(st)

    def _replay_chunk(self, toks: np.ndarray, tele, rows) -> None:
        """Replay one decode chunk's telemetry row by row, emit each row's
        decode event, and finalize the rows it finished."""
        self._faults.fire("replay.chunk", rows=len(rows))
        leaves = _numpy(tele)
        for r, st, keep, ctx0, is_done in rows:
            if keep:   # this row's live steps are the chunk's first
                new = [int(t) for t in toks[:keep, r]]
                st.tokens.extend(new)
                # telemetry leaves are (T, L, B, E): this row's block
                timings, totals, wbytes = self.engine._replay(
                    *(None if x is None else x[:keep, :, r]
                      for x in leaves),
                    phase="decode", s_ctx=ctx0 + np.arange(keep), s_q=1,
                    orch=self._orch)
                st.step_totals.extend(totals)
                st.decode_timings.extend(timings)
                st.decode_weight_bytes += wbytes
                self._emit(st, "decode", new, float(sum(totals)),
                           ctx0 - st.prompt_len)
            if is_done:
                self._finalize(st)

    # --------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *,
            pipeline: Optional[bool] = None,
            rng_keys: Optional[Sequence] = None) -> List:
        """Submit every request, step until idle, :meth:`flush` the replay
        stream, close, return the results in submission order (a request
        that failed under a fault raises its typed error here).
        ``pipeline`` overrides ``SchedulerConfig.pipeline``; ``rng_keys``
        optionally gives request i an explicit PRNG root (overriding its
        seed)."""
        if not requests:
            return []
        b = self._num_slots or min(len(requests), self.scfg.num_slots)
        self._ensure_started(num_slots=max(1, min(b, len(requests))),
                             slots_len=self._slot_budget(requests),
                             pipeline=pipeline)
        handles = [self.submit(r, rng_key=rng_keys[i] if rng_keys else None)
                   for i, r in enumerate(requests)]
        max_chunks = self.scfg.max_chunks or (
            sum(-(-max(r.max_new_tokens - 1, 0) // self._chunk)
                for r in requests) + len(requests) + 1)
        try:
            while self.step():
                assert self.stats["chunks"] <= max_chunks, \
                    f"scheduler made no progress after {max_chunks} chunks"
            self.flush()
        finally:
            self.close()
        assert all(h.done for h in handles)
        return [h.result() for h in handles]
