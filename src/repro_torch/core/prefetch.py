"""Look-ahead prefetching (paper §4.4.1, Eq. 6–8; torch twin of
``repro/core/prefetch.py``): next-layer gate scores are approximated by
pushing the current hidden state through the next layer's router, and the
predicted top-k activations are counted into a per-expert demand."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.importance import stable_topk

__all__ = ["predict_next_gates", "prefetch_targets", "layer_similarity"]


def predict_next_gates(h: torch.Tensor, next_router_w: torch.Tensor
                       ) -> torch.Tensor:
    """Eq. (6). h: (..., dm); next_router_w: (dm, E) -> (..., E) probs."""
    return torch.softmax(h.to(torch.float32) @ next_router_w, dim=-1)


def prefetch_sums(pred_gates: torch.Tensor, k: int,
                  token_valid: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sums over tokens that Eq. (7)'s demand is made of: predicted
    top-k counts (..., E), predicted mass (..., E) and valid tokens
    (..., 1). Sums of disjoint token sets add, so a batch split over
    ranks sums each part over them before :func:`prefetch_demand`."""
    e = pred_gates.shape[-1]
    _, idx = stable_topk(pred_gates, k)                      # (..., T, k)
    oh = torch.nn.functional.one_hot(idx, e).to(torch.float32)
    if token_valid is None:
        n = pred_gates.new_full(pred_gates.shape[:-2] + (1,),
                                float(pred_gates.shape[-2]))
        return oh.sum(dim=(-3, -2)), pred_gates.sum(dim=-2), n
    tv = token_valid.to(torch.float32)
    return ((oh * tv[..., None, None]).sum(dim=(-3, -2)),
            (pred_gates * tv[..., None]).sum(dim=-2),
            tv.sum(dim=-1, keepdim=True))


def prefetch_demand(counts: torch.Tensor, mass: torch.Tensor,
                    n: torch.Tensor, t: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (7)/(8) from :func:`prefetch_sums`: the counts plus half the
    mean predicted mass as tie-break; returns the top-t experts of that
    demand and the demand, (expert_ids (..., t), freq (..., E))."""
    freq = counts + mass / torch.clamp(n, min=1.0) * 0.5
    _, top = stable_topk(freq, min(t, freq.shape[-1]))
    return top, freq


def prefetch_targets(pred_gates: torch.Tensor, k: int, t: int,
                     token_valid: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (7)/(8): predicted top-k activations counted over tokens, plus
    half the mean predicted mass as tie-break; the top-t experts of that
    demand are prefetched. ``pred_gates`` is (..., T, E) — leading dims
    are independent rows — and ``token_valid`` (..., T) drops padding.
    Returns (expert_ids (..., t), freq (..., E))."""
    return prefetch_demand(*prefetch_sums(pred_gates, k, token_valid), t)


def layer_similarity(h_l: torch.Tensor, h_next: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between adjacent-layer activations (paper Fig. 6):
    the mean over tokens of each token's cosine, 0-d f32."""
    a = h_l.to(torch.float32).reshape(-1, h_l.shape[-1])
    b = h_next.to(torch.float32).reshape(-1, h_next.shape[-1])
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) \
        * torch.linalg.vector_norm(b, dim=-1) + 1e-9
    return (num / den).mean()
