"""SLO-aware scheduling policies over the step-driven serving session
(torch port's copy of ``repro/serving/policy.py``; pure Python and numpy).

The scheduler carries the SLO *plumbing* (wall-clock ``deadline_s`` /
``ttft_deadline_s`` with shedding and in-flight eviction, bounded-queue
backpressure; retry helpers in ``faults.py``); this module is the *policy*
layer on top of it, grounded in D²MoE's dynamic scheduling (arXiv
2504.15299) and "Mixture of Experts with Mixture of Precisions for Tuning
Quality of Service": under overload the robust move is to reorder, shed,
preempt and — the coupling this repo is uniquely positioned for — *degrade
precision gracefully* instead of missing every deadline at full quality.

A :class:`SchedulingPolicy` plugs into
:class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler` (the
``policy=`` argument of ``SchedulerConfig`` / ``DyMoEEngine.serve``) and
decides four things at every chunk boundary:

  1. **Admission order** (:meth:`SchedulingPolicy.order`): FIFO by
     default; :class:`EDFPolicy` sorts by (priority desc, earliest
     effective deadline, submission order) — a stable sort, so requests
     with no priority and no deadline keep their exact FIFO order (the
     bit-exactness property the parity tests pin).
  2. **Feasibility** (:meth:`SchedulingPolicy.infeasible`): a queued
     request whose *optimistic* modeled service time (priced by
     :class:`~repro_torch.serving.cost_model.EdgeCostModel` with the depth
     schedule's per-layer Critical counts, Eq. 4–5) can no longer fit
     inside its remaining deadline budget is provably hopeless — it is
     shed at admission with ``DeadlineExceeded(infeasible=True)`` instead
     of burning a slot until wall-clock expiry. The estimate is a lower
     bound on purpose: a request is only shed when even the best case
     misses.
  3. **Preemption** (:meth:`SchedulingPolicy.preempt`): when every slot
     is busy and the head-of-queue request strictly outranks the weakest
     in-flight row, that row is evicted at the chunk boundary via the
     existing eviction path and requeued order-preserving (it re-prefills
     on resume; resume-without-recompute belongs to the prefix-cache
     roadmap item). Equal rank never preempts, so priority-less sessions
     are preemption-free by construction.
  4. **Pressure → precision** (:meth:`SchedulingPolicy.rung_for`): an
     :class:`SLOPressure` snapshot (queue depth per slot, aggregate
     deadline headroom) walks a hysteresis-guarded
     :class:`DegradationLadder` whose rungs are host-side
     :class:`~repro_torch.core.orchestrator.DegradeOverride`\\ s — shrink the
     Critical set, tighten ``prefetch_topk``, and at the last rung flip
     sub-critical experts to skip ("4/0"). Device math is untouched
     (tokens stay bit-identical; only the modeled accounting degrades),
     so no rung adds a compiled decode-chunk key. Quality is restored in
     full when pressure clears.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.orchestrator import DegradeOverride
from repro_torch.core.schedule import critical_counts

__all__ = ["SLOPressure", "DegradationLadder", "SchedulingPolicy",
           "FIFOPolicy", "EDFPolicy", "make_policy",
           "estimate_service_s", "effective_deadline"]


# ------------------------------------------------------------- pressure
@dataclasses.dataclass(frozen=True)
class SLOPressure:
    """One chunk boundary's overload signal, computed by the scheduler.

    ``depth_per_slot`` is the admission-queue depth divided by the slot
    count — the primary input of the ladder (1.0 means a full extra batch is
    waiting). ``min_headroom_s`` / ``mean_headroom_s`` aggregate the
    remaining wall-clock deadline budget across queued *and* in-flight
    requests that carry one (None when nobody does): negative headroom
    means deadlines are already being missed.
    """

    queue_depth: int
    in_flight: int
    slots: int
    min_headroom_s: Optional[float] = None
    mean_headroom_s: Optional[float] = None

    @property
    def depth_per_slot(self) -> float:
        return self.queue_depth / max(1, self.slots)


# ------------------------------------------------------ degradation ladder
@dataclasses.dataclass(frozen=True)
class DegradationLadder:
    """Hysteresis-guarded mapping from :class:`SLOPressure` to a rung.

    Rung 0 is full quality (no override). Rung ``i >= 1`` engages when
    ``depth_per_slot >= engage[i-1]`` (or when aggregate deadline headroom
    has gone negative, which bumps one extra rung) and releases back below
    only when depth falls to ``release[i-1]`` — strictly less than the
    engage threshold, so a queue oscillating around one threshold does not
    flap the precision ladder. Overrides are cumulative by construction:
    each rung's :class:`DegradeOverride` is strictly harsher than the
    previous one's, ending at the "4/0" skip rung.
    """

    engage: Tuple[float, ...] = (1.0, 2.0, 4.0)
    release: Tuple[float, ...] = (0.5, 1.0, 2.0)
    overrides: Tuple[DegradeOverride, ...] = (
        DegradeOverride(prefetch_topk=1),
        DegradeOverride(critical_keep=0.5, prefetch_topk=1),
        DegradeOverride(critical_keep=0.5, prefetch_topk=0,
                        force_skip=True),
    )

    def __post_init__(self):
        n = len(self.overrides)
        if len(self.engage) != n or len(self.release) != n:
            raise ValueError(
                f"ladder arity mismatch: {n} overrides but "
                f"{len(self.engage)} engage / {len(self.release)} release "
                "thresholds")
        for e, r in zip(self.engage, self.release):
            if not r < e:
                raise ValueError(
                    f"hysteresis requires release < engage, got "
                    f"release={r} >= engage={e}")
        if any(b < a for a, b in zip(self.engage, self.engage[1:])):
            raise ValueError(f"engage thresholds must be ascending: "
                             f"{self.engage}")

    @property
    def num_rungs(self) -> int:
        return len(self.overrides)

    def rung_for(self, pressure: SLOPressure, current: int) -> int:
        """Next rung given the current one (hysteresis lives here)."""
        depth = pressure.depth_per_slot
        rung = 0
        for i, e in enumerate(self.engage):
            if depth >= e:
                rung = i + 1
        # headroom already negative: deadlines are being missed NOW —
        # bump one extra rung beyond what depth alone justifies
        if (pressure.min_headroom_s is not None
                and pressure.min_headroom_s < 0.0 and pressure.queue_depth):
            rung = min(self.num_rungs, rung + 1)
        if rung < current:
            # releasing: only step down while depth is at/below the
            # release threshold of the rung being left
            rung2 = current
            while rung2 > rung and depth <= self.release[rung2 - 1]:
                rung2 -= 1
            rung = rung2
        return rung

    def override_for(self, rung: int) -> Optional[DegradeOverride]:
        return None if rung <= 0 else self.overrides[rung - 1]


# ------------------------------------------------- modeled service bound
def estimate_service_s(cost, cfg, request) -> float:
    """Optimistic modeled service time of one request, for feasibility
    shedding: prefill plus ``max_new_tokens - 1`` decode steps, each layer
    priced by :class:`~repro_torch.serving.cost_model.EdgeCostModel` with the
    depth schedule's per-layer Critical counts (Eq. 4–5) capped at the
    per-token routing width — i.e. assuming a warm cache (no
    Wait-for-Weight stalls) and no queueing. A request whose *remaining*
    deadline budget is below even this bound is provably infeasible.
    """
    import numpy as np

    p = request.prompt_len
    steps = max(0, request.max_new_tokens - 1)
    if cfg.is_moe:
        k = cfg.num_experts_per_tok
        t_l = np.asarray(critical_counts(
            cfg.num_layers, cfg.num_experts, cfg.dymoe.lam,
            cfg.dymoe.depth_schedule))
        n_hi = np.minimum(t_l, k)
        n_lo = (np.zeros_like(n_hi) if cfg.dymoe.low_bits == 0
                else k - n_hi)
    else:
        n_hi = n_lo = 0
    pre = float(np.sum(cost.layer_compute_s(
        phase="prefill", s_ctx=p, s_q=p,
        active_experts_hi=n_hi, active_experts_lo=n_lo,
        tokens_routed=p)))
    dec = float(np.sum(cost.layer_compute_s(
        phase="decode", s_ctx=p + steps, s_q=1,
        active_experts_hi=n_hi, active_experts_lo=n_lo,
        tokens_routed=1)))
    return pre + steps * dec


# --------------------------------------------------------------- policies
class SchedulingPolicy:
    """Pluggable admission/preemption/degradation policy.

    The base class IS the FIFO oracle: identity admission order, no
    feasibility shedding, no preemption, no pressure ladder — the
    scheduler's behavior under it is bit-identical (tokens AND modeled
    numbers) to the pre-policy scheduler, which is what the parity gate
    pins. Subclasses override the four hooks below; every hook is called
    on the driving thread at chunk boundaries only.
    """

    name = "fifo"
    #: preemption/reorder/shed are all gated on this so the FIFO path
    #: stays byte-for-byte the pre-policy code path
    reorders = False
    preemptive = False
    sheds_infeasible = False
    ladder: Optional[DegradationLadder] = None

    def order(self, handles: Sequence, now: float) -> Sequence:
        """Admission order over the queued handles (head admits first)."""
        return handles

    def infeasible(self, handle, now: float, estimate_s: float) -> bool:
        """True when ``handle`` provably cannot meet its deadline even if
        admitted right now (``estimate_s`` is the optimistic modeled
        service bound)."""
        return False

    def preempt(self, queued, in_flight, now: float):
        """Return ``(queued_handle, victim_state)`` when the head queued
        request should evict an in-flight row at this boundary, else
        None. ``in_flight`` is a sequence of ``(slot, _SlotState)``."""
        return None

    def rung_for(self, pressure: SLOPressure, current: int) -> int:
        return 0


class FIFOPolicy(SchedulingPolicy):
    """Blind FIFO — the default and the bit-exactness oracle."""


def effective_deadline(req) -> float:
    """The tighter of the request's two deadlines (inf when it has none),
    as a budget measured from submission."""
    dl = math.inf
    if req.deadline_s is not None:
        dl = req.deadline_s
    if req.ttft_deadline_s is not None:
        dl = min(dl, req.ttft_deadline_s)
    return dl


class EDFPolicy(SchedulingPolicy):
    """Priority tiers + earliest-deadline-first admission, proactive
    infeasibility shedding, chunk-boundary preemption and the pressure
    degradation ladder.

    Ordering key: (priority desc, absolute effective deadline asc,
    submission order). The sort is stable and deadline-less requests sort
    at +inf, so a workload with no priorities and no deadlines keeps its
    exact FIFO order — and with every slot equal-ranked, never preempts —
    which is why preemption-free runs are unchanged under this policy.

    ``shed_infeasible`` / ``preempt_enabled`` / ``ladder`` individually
    gate the three overload responses; ``service_estimate_fn`` overrides
    the modeled service bound (tests inject constants through it).
    """

    name = "edf"
    reorders = True

    def __init__(self, *, shed_infeasible: bool = True,
                 preempt_enabled: bool = True,
                 ladder: Optional[DegradationLadder] = DegradationLadder(),
                 service_estimate_fn=None):
        self.sheds_infeasible = shed_infeasible
        self.preemptive = preempt_enabled
        self.ladder = ladder
        self.service_estimate_fn = service_estimate_fn

    def order(self, handles: Sequence, now: float) -> Sequence:
        return sorted(
            handles,
            key=lambda h: (-h.request.priority,
                           h.submit_t + effective_deadline(h.request),
                           h.index))

    def infeasible(self, handle, now: float, estimate_s: float) -> bool:
        req = handle.request
        budget = effective_deadline(req)
        if not math.isfinite(budget):
            return False
        remaining = budget - (now - handle.submit_t)
        return estimate_s > remaining

    def preempt(self, queued, in_flight, now: float):
        if not self.preemptive or not queued or not in_flight:
            return None
        head = self.order(queued, now)[0]
        # victim: weakest in-flight row — lowest priority, then latest
        # effective deadline, then least progress lost (fewest tokens)
        slot, victim = min(
            in_flight,
            key=lambda rs: (rs[1].request.priority,
                            -(rs[1].handle.submit_t
                              + effective_deadline(rs[1].request)),
                            len(rs[1].tokens)))
        hp, vp = head.request.priority, victim.request.priority
        if hp > vp:
            return head, (slot, victim)
        if hp == vp:
            # deadline-urgent preemption within a tier: the queued head
            # has a strictly earlier effective deadline that has real
            # urgency (finite), while the victim's is later/absent
            hd = head.submit_t + effective_deadline(head.request)
            vd = (victim.handle.submit_t
                  + effective_deadline(victim.request))
            if math.isfinite(hd) and hd < vd:
                return head, (slot, victim)
        return None

    def rung_for(self, pressure: SLOPressure, current: int) -> int:
        if self.ladder is None:
            return 0
        return self.ladder.rung_for(pressure, current)


def make_policy(policy: Union[str, SchedulingPolicy, None]
                ) -> SchedulingPolicy:
    """Resolve a ``policy=`` argument: an instance passes through, a name
    (``"fifo"`` / ``"edf"``) builds the stock policy, None means FIFO."""
    if policy is None:
        return FIFOPolicy()
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy == "fifo":
        return FIFOPolicy()
    if policy == "edf":
        return EDFPolicy()
    raise ValueError(f"unknown scheduling policy {policy!r} "
                     "(expected 'fifo', 'edf', or a SchedulingPolicy)")
