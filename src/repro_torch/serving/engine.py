"""DyMoE serving engine of the port (torch twin of
``repro/serving/engine.py``), in two coupled halves as in the paper's
co-design:

  * **Math** — prefill and chunked decode of the real model through the
    packed mixed-precision weight store, producing exact logits AND DyMoE
    telemetry (Critical masks, active experts, look-ahead predictions).
  * **System** — the :class:`DynamicExpertOrchestrator` replays that
    telemetry against the mixed-precision LRU cache and the edge cost
    model (:class:`EdgeProfile`, an RTX 3090-class card behind PCIe by
    default) to give each request its MODELED edge TTFT / TPOT. These are
    outputs of the cost model, not times of the card that ran the model;
    wall times are measured separately.

Both halves are served by the step-driven continuous-batching scheduler,
an OPEN session (``serve`` / ``submit`` / ``step`` / ``health``, with
``handle.stream()`` / ``cancel()`` / ``result()``, typed faults and their
recovery ladders, and the SLO policy layer), which replays each admission
wave's and each decode chunk's telemetry inline, on the dispatch thread,
right after the boundary's one host sync. Its decode chunks run through
the engine's compiled chunk (``serving/compiled.py``): CUDA graphs
captured per key at first use, replayed from decode states the engine
owns across sessions. ``generate`` and ``generate_batch`` are thin
wrappers over one session; :meth:`DyMoEEngine.generate_reference`
(prefill, then eager ``decode_many`` chunks with one shared Critical set
a layer, replayed inline) is the oracle ``generate`` must equal.
Requests carry per-request sampling parameters
(temperature / top-k / seed) with counter-derived PRNG streams, so a
request's tokens are the same solo and in a batch. Ablation rows of paper
Table 3 map to :class:`EngineConfig` flags (cache / prefetch / dyquant,
and "4/2" vs "4/0" through the config's policy).

The engine runs on CUDA unless the caller passes ``device="cpu"``; it never
falls back from one to the other.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.orchestrator import DynamicExpertOrchestrator, \
    OrchestratorConfig, StepTiming
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _check_supported, decode_many, \
    prefill, quantize_model
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile, \
    expert_bytes
from repro_torch.serving.compiled import CompiledDecodeChunk
from repro_torch.serving.request import Request, RequestHandle
from repro_torch.serving.sampler import fold_in, resolve_sampling, \
    sample_token

__all__ = ["EngineConfig", "DyMoEEngine", "GenerationResult"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    profile: EdgeProfile = dataclasses.field(default_factory=EdgeProfile)
    use_dymoe: bool = True          # quantized mixed-precision execution
    enable_cache: bool = True       # ablation rows 1 vs 2
    enable_prefetch: bool = True    # rows 2 vs 3
    enable_dyquant: bool = True     # rows 3 vs 4 (False: all-high requests)
    max_cache_fraction: float = 0.6  # fraction of VRAM granted to experts
    decode_chunk: int = 16          # decode steps per chunk (one host sync)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    ttft_s: float                   # modeled edge TTFT (EngineConfig.profile)
    tpot_s: float                   # modeled edge per-token latency
    # SERVICE wall time: admission -> last token on host (queue wait
    # split out)
    wall_s: float
    queue_wait_s: Optional[float] = None   # submission -> admission
    # first token on host -> last token on host
    decode_wall_s: Optional[float] = None
    prefill_timing: Optional[StepTiming] = None
    decode_timings: Optional[List[StepTiming]] = None
    cache_stats: Optional[Dict] = None
    # packed expert-weight bytes the grouped quant-matmul read
    prefill_weight_bytes: Optional[int] = None
    decode_weight_bytes_per_tok: Optional[float] = None
    # the request was cancelled mid-flight: ``tokens`` is the partial
    # output up to the chunk boundary where its slot was freed
    cancelled: bool = False
    # the cancellation was forced by the request's wall-clock
    # ``deadline_s`` expiring in flight
    deadline_expired: bool = False
    # times an SLO policy preempted this request at a chunk boundary
    # before it completed (each re-prefilled it on resume; tokens are
    # identical, queue_wait/TTFT accounting restarts at the final
    # admission)
    preempted: int = 0


def to_device(tree, device: torch.device):
    """Move a parameter / quantized-store tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, MixedPrecisionWeights):
        return MixedPrecisionWeights(high=to_device(tree.high, device),
                                     low=to_device(tree.low, device))
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(tree, packed=tree.packed.to(device),
                                   scales=tree.scales.to(device))
    if tree is None:
        return None
    return tree.to(device)


class DyMoEEngine:
    def __init__(self, cfg: ModelConfig, params,
                 engine_cfg: EngineConfig = EngineConfig(), faults=None, *,
                 device=None, qparams=None):
        # ``faults``: optional repro_torch.serving.faults.FaultInjector
        # threaded through the serving hot path (the scheduler's dispatch,
        # admission, replay, preemption and rung sites and the expert
        # cache's blob loads). None = every site is a no-op.
        assert engine_cfg.decode_chunk >= 1, engine_cfg.decode_chunk
        if not engine_cfg.use_dymoe:
            raise NotImplementedError(
                "use_dymoe=False (unquantized execution) is not ported: the "
                "port always runs the routed experts from the packed store")
        cfg.validate()
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.faults = faults
        self.params = to_device(params, self.device)
        self.qparams = to_device(qparams, self.device) if qparams is not None \
            else quantize_model(self.params, cfg)
        self.cost = EdgeCostModel(cfg, engine_cfg.profile)
        # the batched decode chunk, compiled (the JAX engine's jax.jit of
        # decode_many_batched): one CUDA graph per key, replayed from the
        # engine-owned decode states
        self._decode_batched = CompiledDecodeChunk(self)
        # the last batch call's counts (ContinuousBatchingScheduler.stats):
        # chunks, decode steps, batched and solo admission waves, replay
        # jobs and their host seconds, compiled-chunk compiles
        self.last_stats: dict = {}
        self._session = None   # the engine-owned open serving session

    # ------------------------------------------------------------ system
    def _make_orchestrator(self) -> DynamicExpertOrchestrator:
        cfg, e = self.cfg, self.ecfg
        pol = cfg.dymoe
        budget = int(e.profile.vram_bytes * e.max_cache_fraction)
        return DynamicExpertOrchestrator(OrchestratorConfig(
            num_layers=cfg.num_layers,
            num_experts=cfg.num_experts,
            experts_per_token=cfg.num_experts_per_tok,
            bytes_high=expert_bytes(cfg, pol.high_bits),
            bytes_low=(expert_bytes(cfg, pol.low_bits)
                       if pol.low_bits else 0),
            vram_budget_bytes=budget,
            pcie_bw=e.profile.pcie_bw,
            low_is_skip=pol.low_bits == 0,
            enable_cache=e.enable_cache,
            enable_prefetch=e.enable_prefetch,
            enable_dyquant=e.enable_dyquant,
            prefetch_topk=pol.prefetch_topk,
        ), faults=self.faults)

    def _expert_counts(self, crit: np.ndarray, active: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(…, L, E) masks -> (…, L) active hi / lo expert counts."""
        n_active = active.sum(axis=-1)
        n_hi = (active & crit).sum(axis=-1)
        n_lo = n_active - n_hi
        if self.cfg.dymoe.low_bits == 0:
            n_lo = np.zeros_like(n_lo)
        return n_hi, n_lo

    def _replay(self, crit, active, pred, *, phase: str, s_ctx, s_q: int,
                orch: DynamicExpertOrchestrator
                ) -> Tuple[List[StepTiming], List[float], int]:
        """Replay a block of host-side telemetry through the orchestrator.

        ``crit`` / ``active`` / ``pred`` are the (T, L, E) stacked numpy
        masks and predictions (T = 1 for prefill; (L, E) inputs are
        promoted); ``s_ctx`` is the per-step context length, shape (T,).
        Returns (timings, per-step modeled seconds, weight_bytes) where
        ``weight_bytes`` is the packed expert-weight traffic of the block:
        per layer and step, each active Critical expert moves its high-bit
        blob, each active Sub-critical one its low-bit blob (zero in the
        "x/0" skip deployment). The cost model broadcasts over (T, L) and
        the orchestrator consumes the block via ``step_batch``."""
        cfg = self.cfg
        s_ctx = np.asarray(s_ctx)
        t = s_ctx.shape[0]
        crit = np.asarray(crit, bool).reshape(t, cfg.num_layers, -1)
        active = np.asarray(active, bool).reshape(crit.shape)
        pred = np.asarray(pred).reshape(crit.shape)
        # price compute/bytes with the same (possibly degraded) precision
        # mix the orchestrator's cache walk will use
        dcrit, dactive = ((crit, active) if orch.degrade is None
                          else orch.degrade.apply(crit, active))
        n_hi, n_lo = self._expert_counts(dcrit, dactive)  # (T, L)
        wbytes = int(self.cost.moe_weight_bytes(n_hi, n_lo).sum())
        compute = self.cost.layer_compute_s(
            phase=phase, s_ctx=s_ctx[:, None], s_q=s_q,
            active_experts_hi=n_hi, active_experts_lo=n_lo,
            tokens_routed=s_q)                            # (T, L)
        timings = orch.step_batch(crit, active, pred, compute)
        return timings, [x.total_s for x in timings], wbytes

    # ------------------------------------------------- step-driven API
    def serve(self, num_slots: Optional[int] = None, *,
              slots_len: Optional[int] = None,
              max_queue: Optional[int] = None, policy=None):
        """Open (and remember) a step-driven serving session — the open
        counterpart of ``generate_batch`` — and return it;
        :meth:`submit` / :meth:`step` / :meth:`health` delegate to it.

        ``num_slots`` device slots (default 4); ``slots_len`` the per-slot
        cache length (default ``cfg.max_seq_len``; rounded up to a power
        of two), which a request's ``prompt_len + max_new_tokens`` must
        fit; ``max_queue`` bounds the admission queue (a submit beyond it
        raises a typed ``QueueFull``; None = unbounded); ``policy`` is
        ``"fifo"`` (default), ``"edf"`` or a ``SchedulingPolicy``
        (:mod:`repro_torch.serving.policy`).

        An open engine-owned session is retired first: its handles still
        queued or in flight resolve with a typed ``SessionClosed`` and its
        decode state goes back to the engine — drain it yourself before
        re-serving if you want their results."""
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler

        if self._session is not None and not self._session.closed:
            self._session.close()
        session = ContinuousBatchingScheduler(self, num_slots=num_slots)
        session._ensure_started(slots_len=slots_len, max_queue=max_queue,
                                policy=policy)
        self._session = session
        return session

    def submit(self, request: Request, rng_key=None) -> RequestHandle:
        """Queue ``request`` on the engine's serving session (opened with
        defaults if :meth:`serve` wasn't called) for admission at the next
        chunk boundary; returns its :class:`RequestHandle`."""
        if self._session is None or self._session.closed:
            self.serve()
        return self._session.submit(request, rng_key=rng_key)

    def step(self) -> bool:
        """Advance the engine's serving session by one chunk boundary.
        Returns True while there is live or queued work."""
        if self._session is None:
            raise RuntimeError(
                "no serving session is open: call serve() or submit() first")
        return self._session.step()

    def health(self):
        """Fault-tolerance snapshot of the engine's serving session
        (``status="ok"`` with zeroed counters when none was opened)."""
        from repro_torch.serving.faults import SessionHealth

        if self._session is None:
            return SessionHealth(status="ok")
        return self._session.health()

    # -------------------------------------------------------------- API
    def generate(self, request: Request, rng_key=None) -> GenerationResult:
        """Serve one request through a fresh single-slot session; its
        admission is the solo prefill. Its tokens equal its row in a
        ``generate_batch``."""
        return self._run([request], num_slots=1, rng_keys=[rng_key])[0]

    def generate_reference(self, request: Request, rng_key=None
                           ) -> GenerationResult:
        """Single-request REFERENCE path (no scheduler): the solo prefill,
        then ``decode_chunk``-sized :func:`decode_many` chunks (one shared
        Critical set a layer, K2 on the card) with inline telemetry
        replay. Token i's PRNG key is ``fold_in(rng_key, i)``, so outputs
        are chunking-invariant. The oracle :meth:`generate` must equal,
        tokens and modeled numbers."""
        from repro_torch.serving.scheduler import _d2h_async

        cfg, dev = self.cfg, self.device
        temperature, top_k, rng_key = resolve_sampling(
            request, rng_key, context="generate")
        sampling = temperature > 0.0
        if sampling:
            rng_key = torch.as_tensor(rng_key).to(dev)
        s = request.prompt_len
        orch = self._make_orchestrator()
        eos = request.eos_token
        t0 = time.perf_counter()
        prompt = torch.as_tensor([request.prompt_tokens], dtype=torch.int64,
                                 device=dev)
        logits, caches, info = prefill(
            self.params, cfg, prompt, qparams=self.qparams,
            cache_slots=s + request.max_new_tokens)
        tele = _d2h_async((info.critical_masks, info.active_masks,
                           info.predicted_next))
        tok = sample_token(logits, fold_in(rng_key, 0) if sampling else None,
                           temperature=temperature, top_k=top_k)
        tokens: List[int] = [int(tok[0])]   # host sync: prefill complete
        pre_timings, _, pre_wbytes = self._replay(
            *(x.numpy() for x in tele), phase="prefill",
            s_ctx=np.asarray([s]), s_q=s, orch=orch)
        t_dec = time.perf_counter()   # decode wall: after prefill's replay
        decode_timings: List[StepTiming] = []
        tpot_total = 0.0
        dec_wbytes = 0
        done = eos is not None and tokens[0] == eos
        total_steps = request.max_new_tokens - 1
        n_done = 0  # decode steps completed (== tokens sampled - 1)
        while n_done < total_steps and not done:
            chunk = min(self.ecfg.decode_chunk, total_steps - n_done)
            toks_d, caches, infos = decode_many(
                self.params, cfg, tok, caches, num_steps=chunk,
                start_step=n_done + 1, qparams=self.qparams,
                rng_key=rng_key if sampling else None,
                temperature=temperature, top_k=top_k)
            tok = toks_d[-1]
            # the chunk's ONE host sync: the telemetry copies are queued
            # first, so the tokens' fetch completes them
            crit, act, pred = (x.numpy() for x in _d2h_async(
                (infos.critical_masks, infos.active_masks,
                 infos.predicted_next)))
            new = [int(t) for t in toks_d[:, 0].cpu()]
            keep = chunk
            if eos is not None and eos in new:
                keep = new.index(eos) + 1
                done = True
            timings, totals, wbytes = self._replay(
                crit[:keep], act[:keep], pred[:keep], phase="decode",
                s_ctx=s + n_done + 1 + np.arange(keep), s_q=1, orch=orch)
            decode_timings.extend(timings)
            for x in totals:   # per-step adds: equal to decode_chunk=1
                tpot_total += x
            dec_wbytes += wbytes
            tokens.extend(new[:keep])
            n_done += keep
        t_end = time.perf_counter()
        n_dec = max(len(tokens) - 1, 1)
        return GenerationResult(
            tokens=tokens, ttft_s=float(pre_timings[0].total_s),
            tpot_s=float(tpot_total / n_dec), wall_s=t_end - t0,
            decode_wall_s=t_end - t_dec, prefill_timing=pre_timings[0],
            decode_timings=decode_timings or None,
            cache_stats=dataclasses.asdict(orch.cache.stats),
            prefill_weight_bytes=pre_wbytes,
            decode_weight_bytes_per_tok=(
                dec_wbytes / n_dec if decode_timings else None))

    def generate_batch(self, requests: Sequence[Request], rng_key=None, *,
                       num_slots: Optional[int] = None,
                       ) -> List[GenerationResult]:
        """Continuous batching over ``num_slots`` device slots (default
        min(len(requests), 4)): ragged prompts, per-request
        ``max_new_tokens`` / ``eos_token`` / sampling parameters, eviction
        and admission at every chunk boundary, real per-request modeled
        TTFT/TPOT. Results come back in submission order.

        ``rng_key`` is an optional shared PRNG
        root for requests WITHOUT a seed: request i's stream root becomes
        ``fold_in(rng_key, i)`` (a request's own seed wins)."""
        rng_keys = None
        if rng_key is not None:
            rng_keys = [None if r.seed is not None else fold_in(rng_key, i)
                        for i, r in enumerate(requests)]
        return self._run(requests, num_slots=num_slots, rng_keys=rng_keys)

    def _run(self, requests, num_slots, rng_keys):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        session = ContinuousBatchingScheduler(self, num_slots=num_slots)
        out = session.run(requests, rng_keys=rng_keys)
        self.last_stats = dict(session.stats)
        return out
