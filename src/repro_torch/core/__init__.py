"""DyMoE core — the paper's contribution (torch port of ``repro.core``).

* ``schedule``   — depth-aware cosine retention schedule (Eq. 4–5).
* ``importance`` — phase-adaptive expert importance (Eq. 1–3) and critical
  expert selection.
* ``prefetch``   — look-ahead gate prediction (Eq. 6–8).
* ``cache``      — mixed-precision LRU cache manager (§4.4.2).
* ``orchestrator`` — host-side Dynamic Expert Orchestration Engine tying
  cache + prefetcher + cost model together for edge serving.
"""
from repro_torch.core.cache import CacheEntry, MixedPrecisionLRUCache
from repro_torch.core.importance import decode_expert_importance, \
    heavy_hitter_mask, prefill_expert_importance, select_critical
from repro_torch.core.orchestrator import DynamicExpertOrchestrator
from repro_torch.core.prefetch import layer_similarity, \
    predict_next_gates, prefetch_targets
from repro_torch.core.schedule import critical_counts, retention_ratio

__all__ = ["retention_ratio", "critical_counts", "heavy_hitter_mask",
           "prefill_expert_importance", "decode_expert_importance",
           "select_critical", "predict_next_gates", "prefetch_targets",
           "layer_similarity", "MixedPrecisionLRUCache", "CacheEntry",
           "DynamicExpertOrchestrator"]
