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

Both halves are served by the continuous-batching scheduler, which
replays each admission wave's and each decode chunk's telemetry inline,
on the dispatch thread, right after the boundary's one host sync. Its
decode chunks run through the engine's compiled chunk
(``serving/compiled.py``): CUDA graphs captured per key at first use,
replayed from decode states the engine owns across sessions.
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.orchestrator import DynamicExpertOrchestrator, \
    OrchestratorConfig, StepTiming
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _check_supported, quantize_model
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.serving.cost_model import EdgeCostModel, EdgeProfile, \
    expert_bytes
from repro_torch.serving.compiled import CompiledDecodeChunk
from repro_torch.serving.request import Request
from repro_torch.serving.sampler import fold_in

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
                 engine_cfg: EngineConfig = EngineConfig(), *, device=None,
                 qparams=None):
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
        self.params = to_device(params, self.device)
        self.qparams = to_device(qparams, self.device) if qparams is not None \
            else quantize_model(self.params, cfg)
        self.cost = EdgeCostModel(cfg, engine_cfg.profile)
        # the batched decode chunk, compiled (the JAX engine's jax.jit of
        # decode_many_batched): one CUDA graph per key, replayed from the
        # engine-owned decode states
        self._decode_batched = CompiledDecodeChunk(self)
        # the last session's counts (ContinuousBatchingScheduler.stats):
        # chunks, decode steps, batched and solo admission waves, replay
        # jobs and their host seconds, compiled-chunk compiles
        self.last_stats: dict = {}

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
        ))

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

    # -------------------------------------------------------------- API
    def generate(self, request: Request, rng_key=None) -> GenerationResult:
        """Serve one request through a fresh single-slot session; its
        admission is the solo prefill. Its tokens equal its row in a
        ``generate_batch``."""
        return self._run([request], num_slots=1, rng_keys=[rng_key])[0]

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
