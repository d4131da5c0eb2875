"""Front-end router: one session-shaped surface over N replicas.

See the package docstring (``repro_torch.serving.cluster``) for the topology
diagram and the routing / failure-semantics contract; this module holds
the implementation: placement policies, the sticky
:class:`ClusterHandle`, the merged :class:`ClusterHealth` snapshot and
the :class:`ClusterRouter` itself.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.serving.faults import QueueFull, SessionClosed, SessionHealth
from repro_torch.serving.request import Request, _STREAM_END
from repro_torch.serving.cluster.replica import Replica

__all__ = ["ClusterRouter", "ClusterHandle", "ClusterHealth",
           "PLACEMENTS"]


# --------------------------------------------------------------- placement
#
# A placement maps (replicas, rotation hint) -> candidate ORDER: the
# router tries candidates left to right, moving on when one raises
# QueueFull (cross-replica backpressure), and surfaces QueueFull only
# when every live replica rejected.

def _least_loaded(live: Sequence[Replica], rr: int) -> List[Replica]:
    """Lowest (queued + in-flight) first; FIFO tie-break (lifetime
    ``submitted``, then replica index) — the parity oracle: candidate
    order is a pure function of submission order, never of wall-clock
    timing."""
    return sorted(live, key=lambda r: r.load())


def _round_robin(live: Sequence[Replica], rr: int) -> List[Replica]:
    """Strict rotation by submission count, ignoring load."""
    k = rr % len(live)
    return list(live[k:]) + list(live[:k])


PLACEMENTS: Dict[str, Callable] = {
    "least_loaded": _least_loaded,
    "round_robin": _round_robin,
}


# ----------------------------------------------------------------- health
@dataclasses.dataclass(frozen=True)
class ClusterHealth:
    """Aggregated cluster snapshot: per-replica ``SessionHealth`` plus
    merged monotonic counters and router-level state.

    ``status``: ``"ok"`` (every replica ok), ``"degraded"`` (some replica
    degraded or mid-restart — the cluster keeps serving), ``"closed"``.

    ``merged`` sums every integer counter of the per-replica snapshots
    (``submitted``/``completed``/``queue_depth``/``in_flight``/fault
    counters …); its ``status`` is the worst replica status.
    """

    status: str
    replicas: tuple                  # per-replica SessionHealth
    merged: SessionHealth            # counter-summed across replicas
    reroutes: int                    # QueueFull submits placed elsewhere
    restarts: int                    # degraded replicas cold-restarted
    quarantined: tuple               # indices currently draining

    @property
    def submitted(self) -> int:
        return self.merged.submitted

    @property
    def completed(self) -> int:
        return self.merged.completed

    @property
    def queue_depth(self) -> int:
        return self.merged.queue_depth

    @property
    def in_flight(self) -> int:
        return self.merged.in_flight


def _merge(snapshots: Sequence[SessionHealth]) -> SessionHealth:
    out: Dict[str, object] = {}
    for f in dataclasses.fields(SessionHealth):
        vals = [getattr(s, f.name) for s in snapshots]
        if f.name == "status":
            rank = {"ok": 0, "degraded": 1, "closed": 2}
            out["status"] = max(vals, key=lambda v: rank.get(v, 0)) \
                if vals else "ok"
        elif f.name == "last_fault":
            out["last_fault"] = next(
                (v for v in vals if v is not None), None)
        else:
            out[f.name] = sum(vals)
    return SessionHealth(**out)


# ----------------------------------------------------------------- handle
class ClusterHandle:
    """Sticky view of one routed request: every operation —
    ``result``/``stream``/``cancel`` — goes to the replica that owns the
    request, whatever the router did since. Same resolution contract as
    :class:`~repro_torch.serving.request.RequestHandle`: the handle always
    resolves, with a result or a typed error."""

    def __init__(self, router: "ClusterRouter", replica: Replica, inner):
        self._router = router
        self._replica = replica
        self._h = inner
        self.replica = replica.index    # placement decision, for callers

    # ----------------------------------------------------- delegated state
    @property
    def request(self) -> Request:
        return self._h.request

    @property
    def request_id(self) -> str:
        return self._h.request_id

    @property
    def done(self) -> bool:
        return self._h.done

    @property
    def error(self):
        return self._h.error

    def cancel(self) -> None:
        self._h.cancel()
        self._replica.notify()   # so the owning driver sweeps the slot

    # ------------------------------------------------------------ results
    def result(self):
        """Block until the owning replica finalizes this request. With
        driver threads the drivers make progress and this only waits;
        in sync mode this drives the ROUTER (round-robin over replicas)
        exactly like ``RequestHandle.result`` drives its session."""
        if self._router.threaded:
            self._replica.notify()
            return self._h.result(drive=False)
        idle = 0
        while not self._h.done:
            if self._router.spmd:
                # SPMD: decide from the state every rank reaches once its
                # submitted replays have run (RequestHandle.result)
                self._router.flush()
                if self._h.done:
                    break
            if self._router.step():
                idle = 0
                continue
            self._router.flush()
            idle += 1
            if idle > 2 and not self._h.done:
                raise RuntimeError(
                    f"{self.request_id} cannot make progress: the "
                    "cluster is idle but the request never finalized")
        return self._h.result(drive=False)

    def stream(self):
        """Iterate the request's ``TokenChunk`` events (same contract as
        ``RequestHandle.stream``); drives the router in sync mode."""
        if self._router.threaded:
            self._replica.notify()
            yield from self._h.stream(drive=False)
            return
        h = self._h
        settled = False   # SPMD: replays flushed since the last step
        while True:
            try:
                ev = h._events.get_nowait()
            except _queue.Empty:
                if h.done:
                    if h._ended:
                        return
                    continue     # trailing events still landing
                if self._router.spmd and not settled:
                    self._router.flush()
                    settled = True
                    continue
                if not self._router.step():
                    self._router.flush()
                settled = False
                continue
            if ev is _STREAM_END:
                h._ended = True
                return
            yield ev


# ----------------------------------------------------------------- router
class ClusterRouter:
    """Load-balancing front end over a pool of replicas, with the same
    surface as one session: ``submit`` / ``step`` / ``flush`` / ``drain``
    / ``close`` / ``health`` (plus sticky handles carrying ``stream`` /
    ``cancel`` / ``result``).

    Construct over explicit engines (``ClusterRouter([eng0, eng1])``) or
    replicate one engine N ways with :meth:`replicate` (replicas share
    weights, the packed store and the compiled programs; each gets its
    own session, replay worker and orchestrator).

    ``threaded=True`` starts one driver thread per replica (the
    throughput mode: replicas decode concurrently); ``threaded=False``
    multiplexes every replica on the caller's thread via round-robin
    :meth:`step` (the deterministic mode the parity gates drive).
    """

    def __init__(self, engines: Sequence, *, num_slots: int = 2,
                 slots_len: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 max_queue: Optional[int] = None, policy=None,
                 placement: str = "least_loaded",
                 threaded: bool = False,
                 faults: Optional[Sequence] = None,
                 auto_restart: bool = True):
        if not engines:
            raise ValueError("ClusterRouter needs at least one engine")
        if placement not in PLACEMENTS:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"one of {sorted(PLACEMENTS)}")
        if faults is not None and len(faults) != len(engines):
            raise ValueError("faults must align with engines "
                             f"({len(faults)} vs {len(engines)})")
        # SPMD: every rank of a mesh runs this router, and their replicas
        # must issue their device work in one order: rank 0's drivers
        # would interleave differently from rank 1's
        self.spmd = any(e.eager for e in engines)
        if threaded and self.spmd:
            raise ValueError(
                "threaded=True over an engine sharded across a mesh of "
                "several ranks: driver threads would order the replicas' "
                "device work differently on each rank; use threaded=False "
                "(the router then steps its replicas round-robin on the "
                "calling thread, in one order on every rank)")
        self.threaded = threaded
        self.auto_restart = auto_restart
        self.closed = False
        self._placement = PLACEMENTS[placement]
        self._placement_name = placement
        self._lock = threading.Lock()    # placement + counters
        self._rr = 0                     # rotation hint (round_robin)
        self._step_rr = 0                # sync-mode step rotation
        self._reroutes = 0
        self._handles: List[ClusterHandle] = []
        self.replicas: List[Replica] = [
            Replica(i, eng, num_slots=num_slots, slots_len=slots_len,
                    pipeline=pipeline, max_queue=max_queue, policy=policy,
                    faults=faults[i] if faults else None,
                    threaded=threaded)
            for i, eng in enumerate(engines)]

    @classmethod
    def replicate(cls, engine, n: int, **kw) -> "ClusterRouter":
        """N replicas over ONE shared engine (weights, packed store and
        compiled programs shared; sessions and orchestrators per
        replica)."""
        return cls([engine] * n, **kw)

    # ------------------------------------------------------------ submit
    def submit(self, request: Request, rng_key=None) -> ClusterHandle:
        """Place ``request`` on a replica and return its sticky handle.

        Placement tries candidates in policy order; a replica whose
        bounded queue rejects with ``QueueFull`` is skipped and the
        request is REROUTED to the next candidate — the typed error only
        surfaces when every live replica rejected (and then no handle
        exists, exactly like a single session's backpressure contract).
        """
        if self.closed:
            raise SessionClosed("cluster router is closed")
        with self._lock:
            live = [r for r in self.replicas if r.available]
            if not live:
                # every replica is mid-restart: same contract as a full
                # queue — typed, retryable, no handle created
                raise QueueFull("no replica is accepting submissions "
                                "(all quarantined mid-restart); retry")
            order = self._placement(live, self._rr)
            self._rr += 1
        last: Optional[QueueFull] = None
        for k, rep in enumerate(order):
            try:
                inner = rep.submit(request, rng_key)
            except QueueFull as e:
                last = e
                continue
            if k > 0:
                with self._lock:
                    self._reroutes += 1
            h = ClusterHandle(self, rep, inner)
            with self._lock:
                self._handles.append(h)
            return h
        raise QueueFull(
            f"every replica's admission queue is full "
            f"({len(order)} tried); retry later") from last

    # ----------------------------------------------------------- driving
    def step(self) -> bool:
        """Sync mode: drive ONE chunk boundary on each replica, round-
        robin (rotation keeps one slow replica from starving the rest of
        the pool's admissions), running degraded-replica maintenance
        first. Returns True if any replica made progress. With driver
        threads this is a no-op (they drive) and returns False."""
        if self.threaded or self.closed:
            return False
        n = len(self.replicas)
        start = self._step_rr
        self._step_rr = (self._step_rr + 1) % n
        progressed = False
        for i in range(n):
            rep = self.replicas[(start + i) % n]
            if self.auto_restart:
                rep.maintain()
            if not rep.session.closed:
                progressed |= rep.session.step()
        return progressed

    def flush(self) -> None:
        for rep in self.replicas:
            if not rep.session.closed:
                rep.session.flush()

    def drain(self, *, cancel_queued: bool = True) -> None:
        """Resolve everything outstanding: optionally cancel queued
        requests, then drive (sync) or wait on the drivers (threaded)
        until every routed handle is done, and flush."""
        if cancel_queued:
            with self._lock:
                handles = list(self._handles)
            for h in handles:
                if not h.done:
                    h.cancel()
        if self.threaded:
            while True:
                with self._lock:
                    pending = [h for h in self._handles if not h.done]
                if not pending:
                    break
                for h in pending:
                    h._replica.notify()
                time.sleep(0.005)
        else:
            while self.step():
                pass
        self.flush()

    def close(self) -> None:
        """Tear the cluster down: stop the drivers, close every replica
        session (each resolves its still-outstanding handles with a typed
        ``SessionClosed``)."""
        if self.closed:
            return
        self.closed = True
        for rep in self.replicas:
            rep.close()

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.drain(cancel_queued=False)
        self.close()

    # ------------------------------------------------------------ health
    def health(self) -> ClusterHealth:
        snaps = tuple(rep.health() for rep in self.replicas)
        quarantined = tuple(r.index for r in self.replicas
                            if r.quarantined)
        merged = _merge(snaps)
        if self.closed:
            status = "closed"
        elif quarantined or any(s.status == "degraded" for s in snaps):
            status = "degraded"
        else:
            status = "ok"
        with self._lock:
            reroutes = self._reroutes
        return ClusterHealth(
            status=status, replicas=snaps, merged=merged,
            reroutes=reroutes,
            restarts=sum(r.restarts for r in self.replicas),
            quarantined=quarantined)
