"""Phase-adaptive expert importance estimation (paper §4.2; torch twin of
``repro/core/importance.py``).

Prefill (Eq. 1–2): heavy-hitter tokens by received attention mass; an
expert's importance is its heavy-hitter token load. Decode (Eq. 3): an
expert's importance is its gate score. ``select_critical`` turns an
importance vector and the depth schedule's t_l into the Critical mask.

Parity trap — ties: ``jax.lax.top_k`` and the stable ``jnp.argsort`` break
ties by the lower index; ``torch.topk`` promises nothing. Every ranking
here and in the router goes through :func:`stable_topk` or a stable sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["stable_topk", "heavy_hitter_mask", "prefill_expert_importance",
           "prefill_expert_importance_rows", "decode_expert_importance",
           "select_critical", "select_critical_rows"]


def stable_topk(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, ties broken by lower index (stable sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def heavy_hitter_mask(token_importance: torch.Tensor, frac: float
                      ) -> torch.Tensor:
    """Top-⌈frac·S⌉ tokens by attention mass (Eq. 1 → T_imp); (B, S) or
    (S,) -> float mask of the same shape. ``round`` is Python's (half to
    even), as in the JAX package."""
    s = token_importance.shape[-1]
    k = max(1, int(round(frac * s)))
    thresh = stable_topk(token_importance, k)[0][..., -1:]
    return (token_importance >= thresh).to(torch.float32)


def prefill_expert_importance(expert_hh_load: torch.Tensor,
                              expert_load: torch.Tensor) -> torch.Tensor:
    """Eq. (2): heavy-hitter load, ties broken by total load."""
    total = torch.clamp(expert_load.sum(), min=1.0)
    return expert_hh_load + expert_load / (total + 1.0)


def prefill_expert_importance_rows(expert_hh_load: torch.Tensor,
                                   expert_load: torch.Tensor
                                   ) -> torch.Tensor:
    """Per-row Eq. (2): (B, E) loads -> (B, E), each row normalized by its
    own total load."""
    total = torch.clamp(expert_load.sum(dim=-1, keepdim=True), min=1.0)
    return expert_hh_load + expert_load / (total + 1.0)


def select_critical_rows(importance: torch.Tensor, t_l: int) -> torch.Tensor:
    """Per-row top-t_l experts: (B, E) importance -> (B, E) bool. Ranks
    come from a stable descending sort, ties broken by index, like the
    reference's stable ``jnp.argsort(-importance)``."""
    e = importance.shape[-1]
    t_l = min(max(int(t_l), 1), e)
    order = torch.sort(-importance, dim=-1, stable=True).indices
    rank = torch.empty_like(order)
    ar = torch.arange(e, device=importance.device).expand_as(order)
    rank.scatter_(-1, order, ar)
    return rank < t_l


def decode_expert_importance(gate_scores: torch.Tensor) -> torch.Tensor:
    """Eq. (3): importance = gate score. gate_scores: (E,) — for batched
    decode the caller averages gates over the batch first."""
    return gate_scores


def select_critical(importance: torch.Tensor, t_l: int) -> torch.Tensor:
    """Top-t_l experts by importance -> bool mask (E,)."""
    return select_critical_rows(importance[None], t_l)[0]
