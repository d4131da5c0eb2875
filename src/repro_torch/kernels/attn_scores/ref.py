"""Plain PyTorch versions of the attention-mass kernels (torch twin of
``repro/kernels/attn_scores/ref.py`` and of the two passes of
``repro/kernels/attn_scores/attn_scores.py``).

* :func:`attention_with_scores_ref` — the oracle: standard (optionally
  causal) softmax attention and the per-key received mass of DyMoE Eq. 1,
  ``mass_j = sum_i softmax(q_i k^T / sqrt(d))_ij``.
* :func:`flash_fwd_ref` — what K4 computes: out and the per-query
  log-sum-exp, masked logits at -1e30; a query that sees no key gets out 0
  and lse -1e30.
* :func:`key_mass_ref` — what K5 computes from that lse:
  ``mass_j = sum_i exp(s_ij - lse_i)``, masked logits at -1e30.

All take q, k, v (H, S, D) head-major in f32 or bf16 and compute in f32.
They build the (H, S, S) logits whole: they are what a CPU tensor runs and
the yardstick of the kernels, not a way to run long sequences.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["attention_with_scores_ref", "flash_fwd_ref", "key_mass_ref"]

_NEG_INF = -1e30


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """scale q k^T in f32 with the kernels' scale 1/sqrt(D)."""
    d = q.shape[-1]
    return torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                        k.to(torch.float32)) * (1.0 / d ** 0.5)


def _visible(s: int, causal: bool, device) -> torch.Tensor:
    """(S, S) bool: key j is visible to query i."""
    vis = torch.ones((s, s), dtype=torch.bool, device=device)
    return vis.tril() if causal else vis


def attention_with_scores_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (H, S, D) f32, mass (H, S) f32)."""
    s = q.shape[1]
    logits = _logits(q, k)
    if causal:
        logits = logits.masked_fill(~_visible(s, True, q.device), -torch.inf)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("hqk,hkd->hqd", p, v.to(torch.float32))
    return out, p.sum(dim=1)          # sum over queries -> (H, S_k)


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: returns (out (H, S, D) f32, lse (H, S) f32)."""
    vis = _visible(q.shape[1], causal, q.device)
    logits = torch.where(vis, _logits(q, k), _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0, 1.0, l)
    out = torch.einsum("hqk,hkd->hqd", p, v.to(torch.float32)) / safe
    lse = torch.where(l == 0, _NEG_INF, m + torch.log(safe))
    return out, lse[..., 0]


def key_mass_ref(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                 causal: bool = True) -> torch.Tensor:
    """Plain K5: mass (H, S) f32, ``mass_j = sum_i exp(s_ij - lse_i)``."""
    vis = _visible(q.shape[1], causal, q.device)
    logits = torch.where(vis, _logits(q, k), _NEG_INF)
    return torch.exp(logits - lse.to(torch.float32)[..., None]).sum(dim=1)
