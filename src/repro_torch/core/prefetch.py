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


def prefetch_targets(pred_gates: torch.Tensor, k: int, t: int,
                     token_valid: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (7)/(8): predicted top-k activations counted over tokens, plus
    half the mean predicted mass as tie-break; the top-t experts of that
    demand are prefetched. ``pred_gates`` is (..., T, E) — leading dims
    are independent rows — and ``token_valid`` (..., T) drops padding.
    Returns (expert_ids (..., t), freq (..., E))."""
    e = pred_gates.shape[-1]
    _, idx = stable_topk(pred_gates, k)                      # (..., T, k)
    oh = torch.nn.functional.one_hot(idx, e).to(torch.float32)
    if token_valid is not None:
        tv = token_valid.to(torch.float32)
        oh = oh * tv[..., None, None]
        mass = (pred_gates * tv[..., None]).sum(dim=-2) \
            / torch.clamp(tv.sum(dim=-1, keepdim=True), min=1.0)
    else:
        mass = pred_gates.mean(dim=-2)
    freq = oh.sum(dim=(-3, -2)) + mass * 0.5
    _, top = stable_topk(freq, min(t, e))
    return top, freq


def layer_similarity(h_l: torch.Tensor, h_next: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between adjacent-layer activations (paper Fig. 6):
    the mean over tokens of each token's cosine, 0-d f32."""
    a = h_l.to(torch.float32).reshape(-1, h_l.shape[-1])
    b = h_next.to(torch.float32).reshape(-1, h_next.shape[-1])
    num = (a * b).sum(dim=-1)
    den = torch.linalg.vector_norm(a, dim=-1) \
        * torch.linalg.vector_norm(b, dim=-1) + 1e-9
    return (num / den).mean()
