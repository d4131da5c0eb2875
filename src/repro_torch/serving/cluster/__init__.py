"""Multi-replica serving tier of the port (torch twin of
``repro/serving/cluster``): N serving sessions over one shared engine
behind a load-balancing router.

Everything below this package serves on ONE session over ONE engine;
this is the scale-out layer: N full serving sessions (each with its own
orchestrator clock/cache and fault/policy state) behind a front-end
router that speaks the session surface — ``submit`` / ``step`` /
``stream`` / ``cancel`` / ``drain`` / ``close`` / ``health``.

Topology::

                               ClusterRouter
                   submit ──► placement (least_loaded | round_robin)
                   health ◄── merge(SessionHealth × N) + reroutes/restarts
                       │
          ┌────────────┼──────────────┐
          ▼            ▼              ▼
      Replica 0    Replica 1  …   Replica N-1          (sticky handles)
          │            │              │
      [_Driver 0]  [_Driver 1]   [_Driver N-1]   one driver thread per
          │            │              │          replica (threaded=True)
          ▼            ▼              ▼          or round-robin step()
       session      session       session        multiplexed on the
     (scheduler)  (scheduler)   (scheduler)      caller (threaded=False)
          │            │              │
          └────────────┴──────┬───────┘
                              ▼
                         DyMoEEngine             weights, packed store
                     (one lock over each         and compiled programs
                      unit of device work)       shared across replicas

Each session replays its telemetry on its own ``ReplayStream`` worker
(``pipeline=True``, the default, as in the JAX package) or inline
(``pipeline=False``). One difference from the JAX package's tier:

  * **The engine is not thread-safe** (its compiled programs hand out
    fixed outputs that the next call overwrites, and its launch counters
    are process-wide): replicas on driver threads serialize their device
    work on the engine's ``lock``, each unit of work held until its
    outputs have been read or injected; their host work (the replay)
    overlaps.
  * **A sharded engine is one rank of an SPMD program** (the engine's
    ``mesh``; the JAX package partitions with GSPMD instead): every rank
    runs the same router, which must step its replicas in one order on
    every rank, so over a mesh of several ranks the tier runs
    ``threaded=False`` (``threaded=True`` raises) and a handle's
    ``result`` / ``stream`` flush the replays before each decision to
    step.

Routing contract:

  * **Sticky handles** — ``submit`` returns a :class:`ClusterHandle`
    bound to the replica that admitted the request; ``result`` /
    ``stream`` / ``cancel`` always go there, whatever the router does
    afterwards. Every handle resolves (result or typed error) under
    every fault the tier tolerates.
  * **Placement** is a pure function of submission order
    (``least_loaded``: queued+in-flight depth, FIFO tie-break on
    lifetime ``submitted`` then replica index) — never of wall-clock
    timing — so a given submission sequence maps to the same replicas on
    every run: the parity oracle. Per-request tokens equal the solo
    engine's for ANY replica count and placement (the scheduler is
    invariant to batching/chunking/admission order), and per-replica
    modeled TTFT/TPOT equal a standalone session serving the same routed
    subsequence.
  * **Backpressure reroutes before it surfaces**: a replica's
    ``QueueFull`` moves the request to the next candidate; the typed
    error reaches the caller only when EVERY live replica rejected (and
    then no handle exists — a single session's contract, widened).

Failure semantics:

  * A replica whose session DEGRADES (a replay fault) is quarantined —
    placement skips it — then drained through the existing recovery path
    (``drain(cancel_queued=False)``: every accepted request resolves
    normally or with its typed error), closed, and COLD-RESTARTED as a
    fresh session before rejoining the pool. Traffic on the other
    replicas never stops; the router's ``health()`` reports
    ``"degraded"`` while any replica is impaired and the ``restarts``
    counter afterwards.
  * ``close()`` stops every driver and closes every session — each
    resolves its outstanding handles with ``SessionClosed``; no waiter
    is left blocked.

The router itself holds no model state: all serving invariants
(token exactness, fault tolerance, SLO policies) are the per-session
ones.
"""
from repro_torch.serving.cluster.replica import Replica
from repro_torch.serving.cluster.router import ClusterHandle, ClusterHealth, \
    ClusterRouter, PLACEMENTS

__all__ = ["Replica", "ClusterRouter", "ClusterHandle", "ClusterHealth",
           "PLACEMENTS"]
