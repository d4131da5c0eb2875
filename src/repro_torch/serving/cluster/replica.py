"""One replica of the serving tier (torch twin of
``repro/serving/cluster/replica.py``): a ``ContinuousBatchingScheduler``
session plus the machinery the router needs around it — an optional
dedicated driver thread, a load snapshot for placement, and the
drain-and-cold-restart path for degraded sessions.

A replica is deliberately thin: every serving behavior (admission,
chunking, replay, faults, SLO policy) lives in the session it wraps.
Replicas may share ONE :class:`~repro_torch.serving.engine.DyMoEEngine`
(weights, the packed store and the compiled programs are
request-independent; the engine's ``lock`` serializes each session's
device work, so driver threads never see each other's outputs) while each
session keeps its own orchestrator (modeled clock + expert cache) and
fault/policy state — so per-request modeled numbers on a replica are
exactly what a standalone session serving the same subsequence reports.
Each session replays on its own worker thread (``pipeline=True``, the
default) or inline (``pipeline=False``); a cold restart closes the old
session, and with it its worker.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from repro_torch.serving.faults import SessionClosed, SessionHealth
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

__all__ = ["Replica"]


def _carry_counters(prior: SessionHealth, current: SessionHealth,
                    ) -> SessionHealth:
    """Current session's snapshot plus the summed counters of every
    RETIRED session of this replica, so a replica's health stays
    lifetime-monotonic across cold restarts. Retired sessions were
    drained before close, so their gauges (queue_depth/in_flight) are
    zero and summing every int field is safe. ``status`` is the live
    session's; ``last_fault`` keeps the retired fault visible until the
    fresh session records one of its own."""
    out = {}
    for f in dataclasses.fields(SessionHealth):
        cur = getattr(current, f.name)
        if f.name == "status":
            out[f.name] = cur
        elif f.name == "last_fault":
            out[f.name] = cur if cur is not None else \
                getattr(prior, f.name)
        elif isinstance(cur, bool) or not isinstance(cur, int):
            out[f.name] = cur
        else:
            out[f.name] = cur + getattr(prior, f.name)
    return SessionHealth(**out)


class _Driver(threading.Thread):
    """Per-replica driving thread: the ONE thread allowed to call the
    wrapped session's ``step()``. Steps while the session makes progress,
    flushes the replay stream when it idles (finalizing any requests
    whose device work completed), then sleeps on a wake event that
    ``submit``/``cancel`` set."""

    def __init__(self, replica: "Replica"):
        super().__init__(daemon=True,
                         name=f"cluster-driver-{replica.index}")
        self._replica = replica
        self._wake = threading.Event()
        self._halt = threading.Event()

    def wake(self) -> None:
        self._wake.set()

    def stop(self) -> None:
        self._halt.set()
        self._wake.set()

    def run(self) -> None:
        r = self._replica
        while not self._halt.is_set():
            progressed = False
            try:
                while r.session.step():
                    progressed = True
                    if self._halt.is_set():
                        break
                r.session.flush()
                r.maintain()
            except Exception as exc:  # noqa: BLE001 — a dying driver
                # would strand its replica's handles; the session absorbs
                # faults itself, so anything reaching here is unexpected
                # — kept for the caller (``Replica.last_error``), then
                # back off and retry
                r.last_error = exc
                progressed = False
            if not progressed and not self._halt.is_set():
                self._wake.wait(timeout=0.02)
                self._wake.clear()


class Replica:
    """A router-managed serving session: sticky home of every request
    placed on it.

    ``threaded=True`` gives the replica its own :class:`_Driver`; with
    ``threaded=False`` the ROUTER's round-robin ``step()`` drives it
    (the deterministic mode the parity gates use).

    ``faults`` is a per-replica injector override: replicas sharing one
    engine still fault independently (the replica-fault demo degrades
    exactly one).
    """

    def __init__(self, index: int, engine, *, num_slots: int = 2,
                 slots_len: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 max_queue: Optional[int] = None,
                 policy=None, faults=None, threaded: bool = False):
        self.index = index
        self.engine = engine
        self.restarts = 0
        self.quarantined = False
        # the last exception a driver thread caught from the session
        self.last_error: Optional[BaseException] = None
        self._retired: Optional[SessionHealth] = None  # summed, restarts
        self._faults = faults
        self._knobs = dict(num_slots=num_slots, slots_len=slots_len,
                           pipeline=pipeline, max_queue=max_queue,
                           policy=policy)
        # guards session swap (cold restart) against concurrent submit
        self._lock = threading.Lock()
        self.session = self._new_session()
        self._driver: Optional[_Driver] = None
        if threaded:
            self._driver = _Driver(self)
            self._driver.start()

    # ----------------------------------------------------------- session
    def _new_session(self) -> ContinuousBatchingScheduler:
        k = self._knobs
        s = ContinuousBatchingScheduler(
            self.engine, num_slots=k["num_slots"], faults=self._faults)
        s._ensure_started(slots_len=k["slots_len"], pipeline=k["pipeline"],
                          max_queue=k["max_queue"], policy=k["policy"])
        return s

    def submit(self, request, rng_key=None):
        """Submit onto the CURRENT session under the swap lock. A submit
        that races the narrow window of a cold restart (old session
        closed, fresh one not yet swapped in) retries until the restart
        finishes rather than surfacing a spurious ``SessionClosed`` —
        placement normally never sends here while quarantined, so the
        loop only spins across that window."""
        while True:
            with self._lock:
                s = self.session
            try:
                h = s.submit(request, rng_key)
                break
            except SessionClosed:
                with self._lock:
                    swapped = self.session is not s
                if not swapped and not self.quarantined:
                    raise        # genuinely closed, not mid-restart
                time.sleep(0 if swapped else 0.002)
        self.notify()
        return h

    def notify(self) -> None:
        if self._driver is not None:
            self._driver.wake()

    # --------------------------------------------------------- placement
    def load(self):
        """(queued + in-flight, lifetime submitted, index): the router's
        least-loaded placement key. ``submitted`` breaks depth ties
        deterministically (the replica that has historically taken fewer
        requests wins), ``index`` breaks the rest — together the FIFO
        tie-break that makes placement a pure function of submission
        order, the property the parity oracle relies on."""
        h = self.session.health()
        return (h.queue_depth + h.in_flight, h.submitted, self.index)

    def health(self) -> SessionHealth:
        """Lifetime snapshot: the live session's health plus the summed
        counters of every session retired by a cold restart, so
        ``submitted``/``completed``/fault counters stay monotonic across
        the replica's whole life (the property ``ClusterHealth.merged``
        and the least-loaded tie-break rely on)."""
        h = self.session.health()
        if self._retired is not None:
            h = _carry_counters(self._retired, h)
        return h

    @property
    def available(self) -> bool:
        return not self.quarantined and not self.session.closed

    # ---------------------------------------------------------- recovery
    def maintain(self) -> bool:
        """Drain-and-cold-restart a degraded session (replay fault fired;
        it is serving on in inline-replay fallback). The existing
        recovery path does the heavy lifting: quarantine (placement skips
        this replica), let every already-accepted request resolve
        (``drain(cancel_queued=False)`` — their handles finish normally
        or with their typed errors), close the old session, then swap in
        a fresh one and rejoin the pool. Returns True if a restart
        happened. Called by the driver thread (threaded mode) or the
        router's ``step`` (sync mode); no-op on healthy sessions."""
        s = self.session
        if s.closed or s.health().status != "degraded":
            return False
        self.quarantined = True
        try:
            s.drain(cancel_queued=False)
            s.close()
            final = s.health()
            self._retired = final if self._retired is None else \
                _carry_counters(self._retired, final)
            with self._lock:
                self.session = self._new_session()
            self.restarts += 1
        finally:
            self.quarantined = False
        return True

    # ---------------------------------------------------------- teardown
    def stop(self) -> None:
        if self._driver is not None:
            self._driver.stop()
            self._driver.join(timeout=5.0)
            self._driver = None

    def close(self) -> None:
        self.stop()
        self.session.close()
