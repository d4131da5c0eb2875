"""Serving request / response records and the step-driven request handle
(torch port of ``repro/serving/request.py``).

The step-driven serving lifecycle (see
:class:`repro_torch.serving.scheduler.ContinuousBatchingScheduler`):

    submit(Request) -> RequestHandle      # validated, queued
      -> admission wave at a chunk boundary (one ragged row-local prefill)
      -> decode chunks with per-row counter-derived PRNG sampling
      -> telemetry replay (the session's replay worker, in FIFO order,
         or inline with ``pipeline=False``) emits TokenChunk events
      -> handle.result() / handle.stream() / handle.cancel()

``SamplingParams`` is validated at construction — a malformed request
fails at submission, never mid-chunk inside the scheduler where it would
poison a whole slot batch.
"""
from __future__ import annotations

import dataclasses
import math
import queue as _queue
import threading
from typing import Iterator, List, Optional

__all__ = ["Request", "SamplingParams", "TokenChunk", "RequestHandle"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.

    ``temperature <= 0`` is greedy. ``temperature > 0`` draws from the
    (optionally top-k truncated) categorical; the PRNG stream is derived
    from ``seed`` (``fold_in(PRNGKey(seed), token_index)``), which makes
    sampled tokens bit-identical between solo ``generate``,
    ``generate_reference`` and continuous batching, and invariant to
    ``decode_chunk`` and admission order. ``temperature > 0`` without a seed (or an explicit
    ``rng_key`` at submission) falls back to greedy with a warning.
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: Optional[int] = None

    def __post_init__(self):
        # `not >= 0` (instead of `< 0`) also rejects NaN
        if not (self.temperature >= 0.0) or math.isinf(self.temperature):
            raise ValueError(
                f"SamplingParams.temperature must be a finite float >= 0, "
                f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(
                f"SamplingParams.top_k must be >= 0, got {self.top_k} "
                f"(a negative value would reach lax.top_k mid-chunk)")


@dataclasses.dataclass
class Request:
    prompt_tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_token: Optional[int] = None   # stop (inclusive) when sampled
    request_id: Optional[str] = None
    seed: Optional[int] = None        # per-request PRNG stream root
    # SLO tier: higher admits first under priority-aware policies and may
    # preempt strictly-lower-priority in-flight rows at a chunk boundary
    # (repro_torch.serving.policy). 0 — the default — is bulk traffic; the
    # field is ignored entirely under the FIFO policy.
    priority: int = 0
    # WALL-CLOCK deadlines, measured from submission. ``deadline_s``: the
    # whole-request budget — expired while queued, the request is shed
    # with a typed ``DeadlineExceeded`` before wasting a prefill wave;
    # expired in flight, the slot is freed at the next chunk boundary and
    # the partial result carries ``deadline_expired=True``.
    # ``ttft_deadline_s``: first-token budget — only meaningful while
    # queued (admission samples the first token), shed the same way.
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    # ``sampling`` is a CONSTRUCTION convenience, not a stored field
    # (InitVar): when given, it overwrites temperature/top_k/seed, which
    # are the single source of truth afterwards. Because replace() never
    # re-passes an InitVar, both ``dataclasses.replace(req,
    # temperature=...)`` and ``dataclasses.replace(req, sampling=...)``
    # do the obvious thing with no stale-side ambiguity. Read the
    # validated bundle back via :attr:`sampling_params`.
    sampling: dataclasses.InitVar[Optional[SamplingParams]] = None

    def __post_init__(self, sampling: Optional[SamplingParams]):
        # fail at submission, not mid-chunk inside the scheduler, where a
        # malformed request would poison a whole slot batch
        if len(self.prompt_tokens) == 0:
            raise ValueError("Request.prompt_tokens must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"Request.max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")
        if not isinstance(self.priority, int) or \
                isinstance(self.priority, bool):
            raise ValueError(
                f"Request.priority must be an int (higher = more "
                f"important), got {self.priority!r}")
        for name in ("deadline_s", "ttft_deadline_s"):
            v = getattr(self, name)
            if v is not None and (math.isnan(v) or v < 0.0):
                raise ValueError(
                    f"Request.{name} must be a non-negative number of "
                    f"seconds (or None), got {v}")
        if sampling is not None:
            self.temperature = sampling.temperature
            self.top_k = sampling.top_k
            self.seed = sampling.seed
        # validate (constructing SamplingParams raises on bad values)
        SamplingParams(temperature=self.temperature, top_k=self.top_k,
                       seed=self.seed)

    @property
    def sampling_params(self) -> SamplingParams:
        return SamplingParams(temperature=self.temperature,
                              top_k=self.top_k, seed=self.seed)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens)


@dataclasses.dataclass(frozen=True)
class TokenChunk:
    """One stream event: the tokens a request gained in one replay unit
    (its prefill, or its live steps of one decode chunk), delivered in
    replay order — i.e. exactly the order the modeled clock advanced."""

    request_id: str
    phase: str                 # "prefill" | "decode"
    tokens: List[int]          # tokens added by this unit (may be empty)
    modeled_s: float           # modeled latency of this unit's live steps


_STREAM_END = object()   # per-handle event-queue sentinel, queued last


class RequestHandle:
    """Live view of one submitted request.

    Created by ``submit``; the request then flows through the step-driven
    session (admission -> chunks -> replay) while this handle exposes it:

      * :meth:`result` — the final ``GenerationResult``; drives the
        session's :meth:`step` loop itself when the caller isn't. A
        request that FAILED (replay fault, dispatch failure, deadline
        shed, session closed — see :mod:`repro_torch.serving.faults`)
        resolves by RAISING its typed
        :class:`~repro_torch.serving.faults.ServingError` here; inspect
        :attr:`error` to check without raising.
      * :meth:`stream` — iterator of :class:`TokenChunk` events, delivered
        as each replay unit runs (on the session's replay worker, or
        inline at the chunk boundary that fetched its tokens with
        ``pipeline=False``). The iterator simply ENDS when the request
        resolves — with a result or a typed error.
      * :meth:`cancel` — frees the slot at the next chunk boundary; the
        result becomes partial (``result().cancelled``).

    Every submitted handle RESOLVES — result or typed error — under every
    fault the session tolerates; ``done`` is True either way.

    The event queue is written by the session's replay (its worker thread
    when pipelined) and read here. Only ONE thread may drive
    ``session.step()``: iterate
    ``stream()`` (or call ``result()``) with the default ``drive=True``
    from that driving thread, or with ``drive=False`` from a separate
    consumer thread that only waits while someone else drives.
    """

    def __init__(self, session, index: int, request: Request,
                 submit_t: float):
        self._session = session
        self.index = index
        self.request = request
        self.request_id = request.request_id or f"req-{index}"
        self.submit_t = submit_t
        self.cancel_requested = False
        # effective sampling state, resolved at submission (greedy
        # fallback applied); key is host uint32[2] or None
        self.temperature = 0.0
        self.top_k = 0
        self.key = None
        # tokens already DELIVERED to this handle's stream (single writer:
        # the replay). After a chunk-boundary preemption the request
        # re-prefills from scratch on resume — regenerating identical
        # tokens — and the resumed incarnation's replay suppresses events
        # up to this watermark, so the stream never repeats a token and
        # its concatenation still equals result().tokens exactly.
        self._streamed = 0
        # times this request was preempted (policy layer); surfaced on
        # the final GenerationResult
        self._preempted = 0
        self._events: _queue.Queue = _queue.Queue()
        self._finished = threading.Event()
        self._ended = False      # this handle's iterator consumed the
        #                          end sentinel (single-consumer streams)
        self._result = None
        self._error: Optional[BaseException] = None
        # first finalizer wins: a natural completion racing a fault-path
        # error (or a session close) must not overwrite the result
        self._finish_lock = threading.Lock()

    # ------------------------------------------------------------- state
    @property
    def done(self) -> bool:
        return self._finished.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        """The typed :class:`~repro_torch.serving.faults.ServingError`
        this request resolved with, or None (still running, or
        succeeded)."""
        return self._error

    def cancel(self) -> None:
        """Request cancellation: the scheduler frees this request's slot
        at the next chunk boundary (or drops it from the queue if not yet
        admitted) and finalizes a partial result. No-op once finished."""
        if not self._finished.is_set():
            self.cancel_requested = True

    # ----------------------------------------------------------- results
    def result(self, *, drive: bool = True):
        """Block until this request finalizes and return its
        ``GenerationResult``. With ``drive=True`` (the default) this drives
        ``session.step()`` / ``session.flush()`` itself until the replay
        finalizes the handle; with ``drive=False`` it only WAITS for
        another thread's driving (bailing out if the session's replay
        stream poisons: no finalize can come then)."""
        while not self._finished.is_set():
            if not drive:
                self._raise_if_poisoned()
                self._finished.wait(timeout=0.05)
                continue
            if self._spmd():
                # one rank's replay worker may finalize this handle before
                # another's: decide to step only from the state every
                # rank reaches once its submitted replays have run
                self._session.flush()
                if self._finished.is_set():
                    break
            if not self._session.step():
                self._session.flush()   # replay queue -> finalize
                if not self._finished.is_set():
                    raise RuntimeError(
                        f"{self.request_id} cannot make progress: the "
                        "session is idle but the request never finalized")
        if self._error is not None:
            raise self._error
        return self._result

    def stream(self, *, drive: bool = True) -> Iterator[TokenChunk]:
        """Iterate this request's :class:`TokenChunk` events in replay
        order; ends when the request finalizes — the concatenated event
        tokens equal ``result().tokens``. With ``drive=True`` (default)
        the iterator drives the session itself while the event queue runs
        dry (same contract as :meth:`result`); pass ``drive=False`` when
        consuming from a second thread while another thread drives —
        the iterator then only WAITS for events."""
        settled = False   # SPMD: replays flushed since the last step
        while True:
            try:
                ev = self._events.get_nowait()
            except _queue.Empty:
                if self._finished.is_set():
                    # _finish() sets the event before enqueueing the
                    # sentinel: if we haven't consumed the sentinel yet,
                    # it is in — or about to hit — the queue; keep
                    # draining instead of returning early
                    if self._ended:
                        return   # sentinel consumed (e.g. second call)
                    continue
                if not drive:
                    self._raise_if_poisoned()
                    try:   # wait for the driving thread's replay
                        ev = self._events.get(timeout=0.05)
                    except _queue.Empty:
                        continue
                elif self._spmd() and not settled:
                    # as in result(): step only from the state every rank
                    # reaches once its submitted replays have run
                    self._session.flush()
                    settled = True
                    continue
                elif not self._session.step():
                    self._session.flush()   # replay queue -> events
                    if not self._finished.is_set() and self._events.empty():
                        raise RuntimeError(
                            f"{self.request_id} cannot make progress: the "
                            "session is idle but the request never "
                            "finalized")
                    continue
                else:
                    settled = False
                    continue
            if ev is _STREAM_END:
                self._ended = True
                return
            yield ev

    def _spmd(self) -> bool:
        return bool(getattr(self._session, "spmd", False))

    def _raise_if_poisoned(self) -> None:
        stream = getattr(self._session, "_stream", None)
        if stream is not None and stream.poisoned:
            raise RuntimeError(
                f"{self.request_id}: the session's replay stream is "
                "poisoned by an earlier job failure; this request will "
                "never finalize")

    # ------------------------------------------- scheduler-facing hooks
    def _push_event(self, ev: TokenChunk) -> None:
        self._events.put(ev)

    def _finish(self, result) -> None:
        # Order matters: result, then the event, then the sentinel — a
        # consumer that observes `done` can rely on the result, and
        # stream() treats `done && sentinel-not-consumed` as "keep
        # draining", so the sentinel may land last
        with self._finish_lock:
            if self._finished.is_set():
                return           # a fault path resolved this handle first
            self._result = result
            self._finished.set()
        self._events.put(_STREAM_END)
        self._notify_completed()

    def _finish_error(self, exc: BaseException) -> None:
        """Resolve this handle with a typed error (fault paths: replay
        fault, dispatch failure, deadline shed, session close). Idempotent
        and a no-op if the request already finished — the first finalizer
        wins, so a fault racing a natural completion never erases a
        result."""
        with self._finish_lock:
            if self._finished.is_set():
                return
            self._error = exc
            self._finished.set()
        self._events.put(_STREAM_END)
        self._notify_completed()

    def _notify_completed(self) -> None:
        # exactly once per handle (both finalizers are first-wins), so
        # the session's monotonic `completed` counter matches resolved
        # handles whatever mix of results and typed errors they carry
        note = getattr(self._session, "_note_completed", None)
        if note is not None:
            note()
