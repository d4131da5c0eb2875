"""DyMoE serving engine of the port (torch twin of the math half of
``repro/serving/engine.py``): greedy prefill and chunked decode of the
real model through the packed mixed-precision weight store, served by the
continuous-batching scheduler.

The host telemetry replay (orchestrator, expert cache, edge cost model) is
not ported yet, so ``GenerationResult.ttft_s`` / ``tpot_s`` are NaN, as
the JAX package's static path returns them. Wall times are measured.

The engine runs on CUDA unless the caller passes ``device="cpu"``; it never
falls back from one to the other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import _check_supported, quantize_model
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.serving.request import Request

__all__ = ["EngineConfig", "DyMoEEngine", "GenerationResult"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    decode_chunk: int = 16          # decode steps per chunk (one host sync)


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    # SERVICE wall time: admission -> result (queue wait split out)
    wall_s: float
    queue_wait_s: Optional[float] = None   # submission -> admission
    decode_wall_s: Optional[float] = None  # first token on host -> result
    ttft_s: float = math.nan        # modeled edge TTFT: not ported yet
    tpot_s: float = math.nan        # modeled edge TPOT: not ported yet


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
        cfg.validate()
        _check_supported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.params = to_device(params, self.device)
        self.qparams = to_device(qparams, self.device) if qparams is not None \
            else quantize_model(self.params, cfg)
        # the last session's dispatch counts (ContinuousBatchingScheduler
        # .stats): chunks, decode steps, batched and solo admission waves
        self.last_stats: dict = {}

    def generate(self, request: Request) -> GenerationResult:
        """Serve one request through a fresh single-slot session (its
        admission is the solo prefill)."""
        return self._run([request], num_slots=1)[0]

    def generate_batch(self, requests: Sequence[Request], *,
                       num_slots: Optional[int] = None
                       ) -> List[GenerationResult]:
        """Continuous batching over ``num_slots`` device slots (default
        min(len(requests), 4)): ragged prompts, per-request
        ``max_new_tokens`` / ``eos_token``, eviction and admission at every
        chunk boundary. Results come back in submission order."""
        return self._run(requests, num_slots=num_slots)

    def _run(self, requests, num_slots):
        from repro_torch.serving.scheduler import ContinuousBatchingScheduler
        session = ContinuousBatchingScheduler(self, num_slots=num_slots)
        out = session.run(requests)
        self.last_stats = dict(session.stats)
        return out
