"""Dynamic Expert Orchestration Engine (paper §4.4) — host-side runtime
(a copy of ``repro/core/orchestrator.py``, plain Python + numpy).

Owns the mixed-precision LRU cache and the look-ahead prefetcher and walks
the layer timeline of one inference step, producing latency accounting under
an explicit edge cost model (single DMA queue, PCIe-class bandwidth):

  1. prefetches for layer l were issued during layer l-1 at LOW priority
     (they occupy the DMA engine only while no demand load is pending —
     demand misses preempt them, as in real driver-level prefetching);
  2. at layer-l start, still-missing *required* experts are fetched and
     compute blocks until they arrive (Wait-for-Weight stall);
  3. compute runs; prefetch requests for layer l+1 overlap with it
     (paper Fig. 1, bottom row).

Prefetch admission is *not* instantaneous: every prefetch records its
modeled DMA completion time (sequential transfers behind the current
``_dma_tail``), and a required expert whose prefetch has not finished by
the time its layer starts charges the residual transfer as Wait-for-Weight
stall — capped at what a plain demand load of the same bytes would have
cost, since a demand fetch can always preempt and re-issue the transfer.
Prefetches for experts that arrive on time count as ``prefetch_hits``.

The engine is exact about the paper's precision semantics: Critical experts
are requested at ``high``; Sub-critical at ``low`` under "4/2" or skipped
outright under "4/0" (the 0-bit state — no I/O, no compute).

This module is deliberately framework-free (plain Python + numpy inputs) so
it can be driven either by the serving engine (routing info from the
model's forward) or by a harness in simulation.

**Replay-ordering contract.** ``step`` / ``step_batch`` advance a modeled
clock, a DMA tail and a shared LRU cache, so the ORDER of replay calls IS
the modeled timeline: callers must replay telemetry in the same order the
modeled device would have executed it (the serving scheduler replays
admissions and decode chunks in dispatch order, on one thread: its
``ReplayStream`` worker, or inline on the dispatch thread). Replaying from two threads
concurrently would silently interleave the clock and the cache's
recency order; both entry points carry a cheap reentrancy guard that
fails loudly instead.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.cache import MixedPrecisionLRUCache

__all__ = ["OrchestratorConfig", "DegradeOverride", "LayerTiming",
           "StepTiming", "DynamicExpertOrchestrator"]


@dataclasses.dataclass(frozen=True)
class OrchestratorConfig:
    num_layers: int
    num_experts: int
    experts_per_token: int
    bytes_high: int               # per-expert blob at high precision
    bytes_low: int                # per-expert blob at low precision
    vram_budget_bytes: int        # expert-cache byte budget
    pcie_bw: float = 16e9         # host->device B/s (PCIe Gen3 x16)
    low_is_skip: bool = False     # "4/0": sub-critical experts are skipped
    enable_cache: bool = True     # ablation row 1 vs 2
    enable_prefetch: bool = True  # ablation row 2 vs 3
    enable_dyquant: bool = True   # False => every expert requested high
    prefetch_topk: int = 2


@dataclasses.dataclass(frozen=True)
class DegradeOverride:
    """One rung of the SLO pressure ladder, applied HOST-SIDE at replay
    time (the JAX package's ``serving/policy.py`` drives it): the device
    program and its tokens are untouched — only the modeled precision
    mix, prefetch budget and therefore the modeled latency accounting
    degrade, while still modeling the paper's precision-for-latency
    trade under overload.

    ``critical_keep``: fraction of each layer's Critical set kept at high
    precision (the rest demote to sub-critical — low bits, or skipped
    under ``force_skip``/"x/0"); kept experts are the lowest ids of the
    set, matching the ascending-id order both replay walks visit.
    ``prefetch_topk``: override of ``OrchestratorConfig.prefetch_topk``
    (0 disables look-ahead prefetch). ``force_skip``: sub-critical
    experts are dropped from the active set outright — the "4/0" rung.
    """

    critical_keep: float = 1.0
    prefetch_topk: Optional[int] = None
    force_skip: bool = False

    def __post_init__(self):
        if not (0.0 < self.critical_keep <= 1.0):
            raise ValueError(
                f"critical_keep must be in (0, 1], got {self.critical_keep}")
        if self.prefetch_topk is not None and self.prefetch_topk < 0:
            raise ValueError(
                f"prefetch_topk override must be >= 0, got "
                f"{self.prefetch_topk}")

    def apply(self, crit: np.ndarray, active: np.ndarray):
        """Degrade ``(..., E)`` critical/active masks (any batch shape).

        Per trailing slice: keep the first ``ceil(keep * n_crit)`` critical
        experts (ascending expert id — never below 1 when the slice had
        any), demote the rest; under ``force_skip`` demoted-and-sub-critical
        experts leave the active set entirely. Returns new arrays; the
        inputs are not mutated.
        """
        crit = np.asarray(crit, bool)
        active = np.asarray(active, bool)
        out_crit = crit
        if self.critical_keep < 1.0:
            n_crit = crit.sum(axis=-1, keepdims=True)
            n_keep = np.ceil(self.critical_keep * n_crit).astype(n_crit.dtype)
            n_keep = np.maximum(n_keep, np.minimum(n_crit, 1))
            rank = np.cumsum(crit, axis=-1)        # 1-based among critical
            out_crit = crit & (rank <= n_keep)
        if self.force_skip:
            return out_crit, active & out_crit
        return out_crit, active


@dataclasses.dataclass
class LayerTiming:
    layer: int
    stall_s: float                # Wait-for-Weight time on the critical path
    compute_s: float
    required_bytes_missed: int
    prefetch_bytes: int
    num_high: int
    num_low: int
    num_skipped: int


@dataclasses.dataclass
class StepTiming:
    layers: List[LayerTiming]

    @property
    def total_s(self) -> float:
        return sum(l.stall_s + l.compute_s for l in self.layers)

    @property
    def stall_s(self) -> float:
        return sum(l.stall_s for l in self.layers)

    @property
    def compute_s(self) -> float:
        return sum(l.compute_s for l in self.layers)

    @property
    def bytes_missed(self) -> int:
        return sum(l.required_bytes_missed for l in self.layers)


class DynamicExpertOrchestrator:
    def __init__(self, cfg: OrchestratorConfig, faults=None):
        # ``faults``: optional FaultInjector threaded into the cache's
        # blob-load sites (chaos testing; None = untouched hot path)
        self.cfg = cfg
        capacity = cfg.vram_budget_bytes
        if not cfg.enable_cache:
            # load-on-demand: room for exactly one layer's working set, so
            # with >= 2 layers nothing survives until the same layer recurs
            # (paper ablation row 1).
            capacity = cfg.bytes_high * cfg.num_experts
        self.cache = MixedPrecisionLRUCache(capacity, faults=faults)
        self._dma_tail = 0.0
        self._now = 0.0
        # current SLO-pressure rung override (None = full quality); set
        # by the serving policy layer at chunk boundaries, read by the
        # replay path — both on the replay timeline, so no lock needed
        self.degrade: Optional[DegradeOverride] = None
        # (layer, expert) -> modeled DMA completion time of an issued
        # prefetch whose arrival has not yet been observed by a demand
        # request (the fix for write-only _dma_tail / instant admission)
        self._pending_prefetch: dict = {}
        # reentrancy guard (see module docstring): a Lock, not a flag, so
        # two threads racing the check cannot both slip past it
        self._replay_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _enter_replay(self) -> None:
        if not self._replay_lock.acquire(blocking=False):
            raise RuntimeError(
                "DynamicExpertOrchestrator: concurrent replay detected — "
                "the modeled clock/cache require replays to be serialized "
                "in timeline order, on one thread)")

    def _exit_replay(self) -> None:
        self._replay_lock.release()

    def set_degrade(self, override: Optional[DegradeOverride]) -> None:
        """Install (or clear, with None) the pressure ladder's current
        rung. Takes effect from the next replayed step; callers sequence
        this with replays (the serving scheduler sets it at chunk
        boundaries, which are ordered against the FIFO replay stream)."""
        self.degrade = override

    def _prefetch_topk(self) -> int:
        if self.degrade is not None and self.degrade.prefetch_topk is not None:
            return self.degrade.prefetch_topk
        return self.cfg.prefetch_topk

    def _bytes(self, precision: str) -> int:
        return (self.cfg.bytes_high if precision == "high"
                else self.cfg.bytes_low)

    def _layer_requests(self, critical_mask: np.ndarray, active: np.ndarray):
        """Vectorized precision assignment for one layer.

        numpy set-ops over the (E,) masks replace the per-expert Python
        branch of :meth:`_required_precisions`: returns ``(ids, is_high,
        n_skip)`` where ``ids`` are the served expert ids in ascending
        order (the same order the scalar walk visits them, so LRU touch /
        eviction order is preserved) and ``is_high`` flags each id's
        requested precision.
        """
        cfg = self.cfg
        act = np.asarray(active, bool)
        if not cfg.enable_dyquant:
            ids = np.flatnonzero(act)
            return ids, np.ones(ids.size, bool), 0
        crit = np.asarray(critical_mask, bool)
        if cfg.low_is_skip:
            ids = np.flatnonzero(act & crit)
            return ids, np.ones(ids.size, bool), int((act & ~crit).sum())
        ids = np.flatnonzero(act)
        return ids, crit[ids], 0

    def _required_precisions(self, critical_mask: np.ndarray,
                             active: np.ndarray):
        """Map (critical, active) per expert -> precision request or skip."""
        out = []
        for e in range(self.cfg.num_experts):
            if not active[e]:
                continue
            if not self.cfg.enable_dyquant:
                out.append((e, "high"))
            elif critical_mask[e]:
                out.append((e, "high"))
            elif self.cfg.low_is_skip:
                out.append((e, None))  # 0-bit: skipped
            else:
                out.append((e, "low"))
        return out

    def _consume_pending(self, key, key_missed: int):
        """Settle a required key's pending-prefetch record at its demand
        lookup, where hit/miss is known. Returns (arrival_time, nbytes)
        when the demand HIT the prefetch-admitted copy (whose modeled
        transfer may still be in flight); None when no prefetch was
        pending — or the prefetched copy was evicted before use and the
        demand just reloaded it (``key_missed`` > 0: that transfer is
        already charged in full as a miss, and the stale arrival must not
        double-charge it or count as a prefetch hit)."""
        arrival = self._pending_prefetch.pop(key, None)
        if arrival is None or key_missed:
            return None
        return arrival, self.cache.resident_nbytes(key)

    def _demand_stall(self, pending, missed: int) -> float:
        """Advance the clock over one layer's Wait-for-Weight phase.

        ``missed`` bytes of demand transfers start at ``_now`` (they
        preempt any in-flight prefetch). ``pending`` holds the
        (arrival, nbytes) records of required experts served by a
        prefetch-admitted copy (:meth:`_consume_pending`): compute
        additionally waits for the latest still-in-flight arrival, capped
        at the cost of demand-loading those same bytes (a demand fetch
        preempts and re-issues at worst); on-time arrivals count as
        prefetch hits. Returns the stall; ``_now`` is advanced past it."""
        bw = self.cfg.pcie_bw
        now = self._now
        done = now + missed / bw
        if missed:
            self._dma_tail = max(self._dma_tail, done)
        late_arrival, late_bytes = 0.0, 0
        for arrival, nbytes in pending:
            if arrival <= done:
                self.cache.note_prefetch_hit()  # arrived in time: free
                continue
            late_arrival = max(late_arrival, arrival)
            late_bytes += nbytes
        if late_bytes:
            done = max(done, min(late_arrival,
                                 now + (missed + late_bytes) / bw))
            self._dma_tail = max(self._dma_tail, done)
        stall = done - now
        self._now = done
        return stall

    def _issue_prefetch(self, pred_l: np.ndarray, l: int,
                        compute_start: float) -> int:
        """Issue look-ahead prefetches for layer l+1 during layer l's
        compute window. Transfers queue sequentially behind the DMA tail
        (never before the compute they overlap with starts); each records
        its modeled completion time for `_demand_stall` to check. Experts
        with zero predicted demand are never prefetched — an all-zero
        prediction must prefetch nothing (argsort alone would fabricate
        topk phantom prefetches out of ties at 0)."""
        cfg = self.cfg
        pred_l = np.asarray(pred_l)
        top = np.argsort(-pred_l)[:self._prefetch_topk()]
        pf_bytes = 0
        tail = max(self._dma_tail, compute_start)
        for e in top:
            if pred_l[e] <= 0:
                continue
            key = (l + 1, int(e))
            # the paper prefetches *critical* experts, i.e. at high
            # precision (§4.4.1 — "prefetch critical weights")
            got = self.cache.prefetch(key, "high",
                                      nbytes=self.cfg.bytes_high)
            if got:
                tail += got / cfg.pcie_bw
                self._pending_prefetch[key] = tail
            pf_bytes += got
        if pf_bytes:
            self._dma_tail = tail
        return pf_bytes

    def step(self, critical_masks: Sequence[np.ndarray],
             active_masks: Sequence[np.ndarray],
             predicted_next: Optional[Sequence[np.ndarray]],
             compute_s_per_layer: Sequence[float]) -> StepTiming:
        """Walk one forward pass (prefill or a decode step).

        critical_masks / active_masks: per layer, (E,) bool — DyMoE's
        Critical tier and the set of experts actually routed to.
        predicted_next: per layer, (E,) predicted demand for layer l+1 from
        Eq. (6–8) (None disables prefetch).
        compute_s_per_layer: modeled compute window per layer.
        """
        self._enter_replay()
        try:
            return self._step(critical_masks, active_masks, predicted_next,
                              compute_s_per_layer)
        finally:
            self._exit_replay()

    def _step(self, critical_masks, active_masks, predicted_next,
              compute_s_per_layer) -> StepTiming:
        cfg = self.cfg
        timings: List[LayerTiming] = []
        for l in range(cfg.num_layers):
            crit_l = np.asarray(critical_masks[l])
            act_l = np.asarray(active_masks[l])
            if self.degrade is not None:   # pressure ladder (host-side)
                crit_l, act_l = self.degrade.apply(crit_l, act_l)
            reqs = self._required_precisions(crit_l, act_l)
            missed = 0
            n_hi = n_lo = n_skip = 0
            per_key = []
            for e, prec in reqs:
                if prec is None:
                    n_skip += 1
                    continue
                if prec == "high":
                    n_hi += 1
                else:
                    n_lo += 1
                _, m = self.cache.get((l, e), prec, nbytes=self._bytes(prec))
                missed += m
                per_key.append(((l, e), m))
            # pending records settle AFTER the whole demand walk (same
            # order as step_batch's get_many, so the scalar/batch clocks
            # agree even when one required key evicts another mid-layer)
            pending = []
            for key, m in per_key:
                p = self._consume_pending(key, m)
                if p is not None:
                    pending.append(p)
            # demand loads PREEMPT in-flight prefetch: they are serviced
            # from `now` directly, and compute additionally blocks on
            # prefetched-but-still-in-flight required experts
            stall = self._demand_stall(pending, missed)
            compute_start = self._now
            self._now += compute_s_per_layer[l]

            # look-ahead prefetch for layer l+1 overlaps with this compute
            pf_bytes = 0
            if (cfg.enable_prefetch and predicted_next is not None
                    and l + 1 < cfg.num_layers):
                pf_bytes = self._issue_prefetch(predicted_next[l], l,
                                                compute_start)
            timings.append(LayerTiming(
                layer=l, stall_s=stall,
                compute_s=compute_s_per_layer[l],
                required_bytes_missed=missed,
                prefetch_bytes=pf_bytes,
                num_high=n_hi, num_low=n_lo, num_skipped=n_skip))
        return StepTiming(timings)

    def step_batch(self, critical_masks, active_masks, predicted_next,
                   compute_s) -> List[StepTiming]:
        """Vectorized replay of a chunk of decode steps (or one prefill).

        Same semantics as calling :meth:`step` once per leading index —
        the scalar ``step`` stays as the oracle and the equivalence is
        tested — but the per-expert precision *branching* is replaced by
        numpy set-ops (:meth:`_layer_requests`) and the cache is driven
        through its bulk ``get_many`` entry point. The LRU admission walk
        inside ``get_many`` is still per-expert (an LRU with byte-budget
        eviction is inherently sequential); what this removes is the
        per-expert Python branching, per-call cost-model work, and
        per-step dispatch overhead around it.

        critical_masks / active_masks: (T, L, E) bool; predicted_next:
        (T, L, E) float or None (disables prefetch); compute_s: (T, L)
        modeled compute windows. Returns one StepTiming per step.
        """
        self._enter_replay()
        try:
            return self._step_batch(critical_masks, active_masks,
                                    predicted_next, compute_s)
        finally:
            self._exit_replay()

    def _step_batch(self, critical_masks, active_masks, predicted_next,
                    compute_s) -> List[StepTiming]:
        cfg = self.cfg
        crit = np.asarray(critical_masks, bool)
        active = np.asarray(active_masks, bool)
        assert crit.ndim == 3 and active.shape == crit.shape, (
            crit.shape, np.shape(active))
        if self.degrade is not None:   # pressure ladder (host-side)
            crit, active = self.degrade.apply(crit, active)
        pred = (None if predicted_next is None
                else np.asarray(predicted_next, float))
        compute = np.asarray(compute_s, float)
        bh, bl = cfg.bytes_high, cfg.bytes_low
        out: List[StepTiming] = []
        for t in range(crit.shape[0]):
            timings: List[LayerTiming] = []
            for l in range(cfg.num_layers):
                ids, is_hi, n_skip = self._layer_requests(
                    crit[t, l], active[t, l])
                n_hi = int(is_hi.sum())
                n_lo = ids.size - n_hi
                keys = [(l, int(e)) for e in ids]
                missed, per_key = self.cache.get_many(
                    keys,
                    ["high" if h else "low" for h in is_hi],
                    [bh if h else bl for h in is_hi])
                pending = []
                for key, m in zip(keys, per_key):
                    p = self._consume_pending(key, m)
                    if p is not None:
                        pending.append(p)
                c = float(compute[t, l])
                stall = self._demand_stall(pending, missed)
                compute_start = self._now
                self._now += c
                pf_bytes = 0
                if (cfg.enable_prefetch and pred is not None
                        and l + 1 < cfg.num_layers):
                    pf_bytes = self._issue_prefetch(pred[t, l], l,
                                                    compute_start)
                timings.append(LayerTiming(
                    layer=l, stall_s=stall, compute_s=c,
                    required_bytes_missed=missed, prefetch_bytes=pf_bytes,
                    num_high=n_hi, num_low=n_lo, num_skipped=n_skip))
            out.append(StepTiming(timings))
        return out

    def reset_clock(self) -> None:
        self._now = 0.0
        self._dma_tail = 0.0
        self._pending_prefetch.clear()
