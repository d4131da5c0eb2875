"""Fault injection + the serving error taxonomy + retry helpers (torch
port's copy of ``repro/serving/faults.py``; pure Python and numpy).

Production MoE serving treats I/O and worker faults as EXPECTED events
(HOBBIT, arXiv 2411.01433, frames expert-load failures this way;
"Mixture of Experts with Mixture of Precisions for Tuning Quality of
Service" frames degrade-instead-of-fail under resource pressure): the
engine must keep serving unaffected requests and resolve every handle —
never hang one, never lose one. This module provides the three pieces the
serving session needs for that contract:

  * a **typed error taxonomy** (:class:`ServingError` and subclasses) —
    every way a request can fail resolves its handle with one of these,
    so callers can tell backpressure (:class:`QueueFull`) from shed load
    (:class:`DeadlineExceeded`) from a degraded engine
    (:class:`ReplayError` / :class:`DispatchError`) and choose a retry
    policy per class;

  * a deterministic, seeded :class:`FaultInjector` with NAMED injection
    points threaded through the serving hot path (replay jobs, device
    dispatch, admission allocation, cache blob loads). It is a no-op by
    default — ``NO_FAULTS.fire`` is one attribute check — so the
    fault-free trace is untouched; the chaos suite drives every
    degradation ladder through it with reproducible schedules;

  * **retry helpers** (:func:`submit_with_retry`, :func:`requeue`,
    :func:`result_with_retry`) implementing cancel-and-requeue with
    exponential backoff over the typed taxonomy.

Injection sites (visit counters are PER SITE, starting at 0):

  ================== ====================================================
  site               visit = one …
  ================== ====================================================
  ``replay.prefill`` admission-wave prefill replay job
  ``replay.chunk``   decode-chunk telemetry replay job
  ``device.dispatch``decode-chunk dispatch ATTEMPT (retries count)
  ``admit.alloc``    admission-wave prefill dispatch attempt
  ``preempt.evict``  chunk-boundary preemption attempt (a raise aborts
                     JUST that preemption — the victim keeps its slot,
                     the urgent request stays queued; nothing fails)
  ``degrade.shift``  pressure-ladder rung transition attempt (a raise
                     skips the shift; the session stays at its rung)
  ``cache.blob.corrupt``  demand load (miss) in the expert cache
  ``cache.blob.oversize`` blob-size lookup in the expert cache (inflate)
  ================== ====================================================

``kind="raise"`` raises :class:`InjectedFault` at the site;
``kind="delay"`` sleeps ``delay_s`` (the slow-replay fault — exercises
replay-queue backpressure without changing any modeled number);
``kind="inflate"`` multiplies a size by ``factor`` (the oversized-blob
fault — drives the cache's bypass ladder). ``probability < 1`` gates each
eligible visit on a ``numpy`` generator seeded at construction, so a
schedule is reproducible run to run.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ServingError", "ReplayError", "DispatchError", "AdmissionError",
    "QueueFull", "DeadlineExceeded", "SessionClosed", "InjectedFault",
    "FaultSpec", "FaultInjector", "NO_FAULTS", "SessionHealth",
    "submit_with_retry", "requeue", "result_with_retry",
]


# --------------------------------------------------------------- taxonomy
class ServingError(RuntimeError):
    """Base of every typed serving failure. A request handle that cannot
    produce a :class:`~repro_torch.serving.engine.GenerationResult` resolves by
    raising one of these from ``handle.result()`` (also exposed without
    raising via ``handle.error``). Subclasses RuntimeError so callers that
    predate the taxonomy keep catching what they caught."""


class ReplayError(ServingError):
    """The host-side telemetry replay failed while this request was in
    flight: its device tokens may exist but its modeled TTFT/TPOT
    accounting is lost (the shared orchestrator clock/cache are no longer
    trustworthy for it). The session rebuilds a fresh orchestrator and
    keeps serving — see ``ContinuousBatchingScheduler`` *Failure
    semantics*."""


class DispatchError(ServingError):
    """A device decode dispatch failed for this request's slot even after
    the retry ladder (halved chunk, then reduced live rows). Only the
    affected slots fail; the session keeps serving."""


class AdmissionError(ServingError):
    """The admission-wave prefill failed for this request even after the
    wave was split down to this single candidate."""


class QueueFull(ServingError):
    """Backpressure: the session's bounded admission queue (``max_queue``)
    is full. Raised synchronously by ``submit`` — no handle is created;
    retry later (see :func:`submit_with_retry`) or shed the request."""


class DeadlineExceeded(ServingError):
    """The request's ``deadline_s`` / ``ttft_deadline_s`` expired while it
    was still queued: it was shed before wasting a prefill wave.

    ``infeasible=True`` marks PROACTIVE shedding by an SLO-aware policy
    (:mod:`repro_torch.serving.policy`): the deadline had not yet expired on
    the wall clock, but the optimistic modeled service bound no longer fit
    the remaining budget — the request provably could not make it, so it was
    shed at admission instead of burning a slot until expiry."""

    def __init__(self, *args, infeasible: bool = False):
        super().__init__(*args)
        self.infeasible = infeasible


class SessionClosed(ServingError):
    """The serving session was closed while this request was still
    queued or in flight; it will never run (further)."""


class InjectedFault(Exception):
    """The raw exception a ``kind="raise"`` :class:`FaultSpec` throws at
    its site. Deliberately NOT a :class:`ServingError`: the serving layer
    must catch it like any unexpected infrastructure exception and
    translate it into the typed taxonomy."""

    def __init__(self, site: str, visit: int, note: str = ""):
        self.site = site
        self.visit = visit
        super().__init__(
            f"injected fault at {site} (visit {visit})"
            + (f": {note}" if note else ""))


# -------------------------------------------------------------- injection
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at site visits ``at .. at+times-1``."""

    site: str
    at: int = 0                # first firing visit (0-based, per site)
    times: int = 1             # consecutive visits that fire
    kind: str = "raise"        # "raise" | "delay" | "inflate"
    delay_s: float = 0.0       # kind="delay": sleep this long
    factor: float = 1.0        # kind="inflate": multiply the value
    probability: float = 1.0   # <1: fire eligible visits with this prob
    note: str = ""             # carried into the InjectedFault message

    def __post_init__(self):
        if self.kind not in ("raise", "delay", "inflate"):
            raise ValueError(f"unknown FaultSpec.kind {self.kind!r}")
        if self.at < 0 or self.times < 1:
            raise ValueError(f"bad fault window at={self.at} "
                             f"times={self.times}")
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError(f"bad probability {self.probability}")


class FaultInjector:
    """Deterministic, seeded fault schedule over named sites.

    Thread-safe: visit counters are lock-guarded (a session's sites are
    hit from its driving thread, which may differ from the submitting
    ones). With no specs every entry
    point is a near-free no-op, so threading ``NO_FAULTS`` through the
    hot path costs one attribute check — the fault-free trace (tokens AND
    modeled numbers) is untouched.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._by_site.setdefault(s.site, []).append(s)
        self._rng = np.random.default_rng(seed)
        self._visits: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, int, str]] = []  # (site, visit, kind)

    def _match(self, site: str) -> Tuple[int, List[FaultSpec]]:
        """Advance the site's visit counter; return matching specs."""
        with self._lock:
            visit = self._visits.get(site, 0)
            self._visits[site] = visit + 1
            hits = []
            for s in self._by_site.get(site, ()):
                if not (s.at <= visit < s.at + s.times):
                    continue
                if s.probability < 1.0 and \
                        self._rng.random() >= s.probability:
                    continue
                hits.append(s)
                self.fired.append((site, visit, s.kind))
            return visit, hits

    def fire(self, site: str, **ctx) -> None:
        """Visit a raise/delay site: sleep for every matching delay spec,
        then raise :class:`InjectedFault` if any raise spec matches."""
        if not self._by_site:
            return
        visit, hits = self._match(site)
        raise_spec = None
        for s in hits:
            if s.kind == "delay":
                time.sleep(s.delay_s)
            elif s.kind == "raise":
                raise_spec = s
        if raise_spec is not None:
            raise InjectedFault(site, visit, raise_spec.note)

    def inflate(self, site: str, value: int) -> int:
        """Visit an inflate site: scale ``value`` by the matching spec's
        factor (identity when none match)."""
        if not self._by_site:
            return value
        _, hits = self._match(site)
        for s in hits:
            if s.kind == "inflate":
                value = int(value * s.factor)
        return value

    def visits(self, site: str) -> int:
        with self._lock:
            return self._visits.get(site, 0)


#: The default injector: no specs, every site a no-op.
NO_FAULTS = FaultInjector(())


# ----------------------------------------------------------------- health
@dataclasses.dataclass
class SessionHealth:
    """Snapshot of a serving session's fault-tolerance state.

    ``status``:
      * ``"ok"`` — no fault has degraded the session;
      * ``"degraded"`` — a replay fault fired: the session rebuilt a
        FRESH orchestrator (modeled numbers for later requests restart
        from a cold expert cache) but keeps serving;
      * ``"closed"`` — the session was closed.
    """

    status: str = "ok"
    replay_faults: int = 0        # replay jobs that raised
    dispatch_retries: int = 0     # decode dispatch attempts that failed
    dispatch_failures: int = 0    # slots failed after the retry ladder
    admission_retries: int = 0    # admission waves split after a failure
    admission_failures: int = 0   # requests failed at admission
    deadline_shed: int = 0        # queued requests shed on deadline
    deadline_evictions: int = 0   # in-flight requests evicted on deadline
    queue_rejections: int = 0     # submits rejected with QueueFull
    queue_depth: int = 0          # currently queued requests
    in_flight: int = 0            # currently admitted requests
    # monotonic lifetime counters (router least-loaded placement reads
    # these: depth+in_flight is the instantaneous load, submitted breaks
    # ties deterministically between equally-loaded replicas)
    submitted: int = 0            # accepted submits, lifetime
    completed: int = 0            # handles resolved (result OR error)
    # SLO policy layer (repro_torch.serving.policy; all zero under FIFO):
    infeasible_shed: int = 0      # proactively shed (modeled bound > SLO)
    preemptions: int = 0          # in-flight rows evicted for urgent work
    pressure_rung: int = 0        # current degradation-ladder rung (0=full)
    rung_transitions: int = 0     # ladder engage/release shifts so far
    last_fault: Optional[str] = None   # repr of the most recent fault


# ------------------------------------------------------------ retry tools
def submit_with_retry(session, request, *, attempts: int = 5,
                      backoff_s: float = 0.01, jitter: float = 0.5,
                      max_elapsed_s: Optional[float] = None,
                      retry_seed: Optional[int] = None, rng_key=None,
                      drive: bool = False,
                      sleep: Callable[[float], None] = time.sleep):
    """``session.submit`` with exponential backoff on :class:`QueueFull`.

    Each backoff is JITTERED: attempt ``i`` sleeps
    ``backoff_s * 2**i * u`` with ``u`` drawn uniformly from
    ``[1 - jitter, 1]`` — so a fleet of clients rejected by the same full
    queue at the same instant spreads out instead of retrying in lockstep
    against it (``jitter=0`` restores the deterministic schedule;
    ``retry_seed`` pins the draw for reproducible tests).
    ``max_elapsed_s`` caps the TOTAL backoff budget: once cumulative
    sleep would exceed it, the pending :class:`QueueFull` re-raises even
    with attempts remaining — a client under overload gives up in bounded
    time instead of stretching its own deadline.

    ``drive=True`` advances the session (``session.step()``) between
    attempts instead of only sleeping — use it when the caller IS the
    driving thread, where sleeping would never drain the queue. The last
    attempt re-raises."""
    if not (0.0 <= jitter <= 1.0):
        raise ValueError(f"jitter must be in [0, 1], got {jitter}")
    rng = np.random.default_rng(retry_seed)
    elapsed = 0.0
    for i in range(attempts):
        try:
            return session.submit(request, rng_key=rng_key)
        except QueueFull:
            if i == attempts - 1:
                raise
            if drive:
                session.step()
                continue
            delay = backoff_s * (2 ** i)
            if jitter:
                delay *= 1.0 - jitter * float(rng.random())
            if max_elapsed_s is not None and \
                    elapsed + delay > max_elapsed_s:
                raise
            elapsed += delay
            sleep(delay)


def requeue(handle, *, attempts: int = 5, backoff_s: float = 0.01,
            jitter: float = 0.5, max_elapsed_s: Optional[float] = None,
            retry_seed: Optional[int] = None, rng_key=None,
            drive: bool = False,
            sleep: Callable[[float], None] = time.sleep):
    """Cancel-and-requeue: cancel ``handle`` (a no-op if it already finished)
    and resubmit its request on the same session with
    :func:`submit_with_retry` backoff. Returns the NEW handle — the
    manual-preemption / transient-failure retry primitive. (Policy-driven
    chunk-boundary preemption — :mod:`repro_torch.serving.policy` — keeps
    the SAME handle and requeues it internally instead.)"""
    handle.cancel()
    return submit_with_retry(handle._session, handle.request,
                             attempts=attempts, backoff_s=backoff_s,
                             jitter=jitter, max_elapsed_s=max_elapsed_s,
                             retry_seed=retry_seed,
                             rng_key=rng_key, drive=drive, sleep=sleep)


#: Error classes worth resubmitting for: the fault was in the engine, not
#: the request (QueueFull is handled inside submit_with_retry's loop).
RETRYABLE = (ReplayError, DispatchError, AdmissionError)


def result_with_retry(session, request, *, attempts: int = 3,
                      backoff_s: float = 0.01, rng_key=None,
                      drive: bool = True,
                      sleep: Callable[[float], None] = time.sleep):
    """Submit and wait for a result, resubmitting on retryable typed
    errors (:data:`RETRYABLE`) with exponential backoff. Raises the last
    error when every attempt fails; non-retryable errors
    (:class:`DeadlineExceeded`, :class:`SessionClosed`) raise at once."""
    last: Optional[BaseException] = None
    for i in range(attempts):
        if i and not drive:
            sleep(backoff_s * (2 ** (i - 1)))
        h = submit_with_retry(session, request, attempts=attempts,
                              backoff_s=backoff_s, rng_key=rng_key,
                              drive=drive, sleep=sleep)
        try:
            return h.result(drive=drive)
        except RETRYABLE as e:
            last = e
    raise last
