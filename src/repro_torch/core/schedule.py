"""Depth-aware precision scheduling (paper §4.3, Eq. 4–5).

    r(l) = (1 - λ) · (cos(π · l / (L-1)) + 1) / 2 + λ
    t_l  = ⌈r(l) · M⌉

The cosine stays near 1 in shallow (quantization-fragile) layers and decays
smoothly toward λ in deep (robust) ones. ``equal`` and ``linear`` variants
reproduce the paper's Fig. 3 comparison strategies.
"""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["retention_ratio", "critical_counts"]


def retention_ratio(layer: int, num_layers: int, lam: float,
                    kind: str = "cosine") -> float:
    """r(l) per Eq. (4) (or the equal/linear ablation variants)."""
    if num_layers <= 1:
        return 1.0
    frac = layer / (num_layers - 1)
    if kind == "cosine":
        return (1.0 - lam) * (math.cos(math.pi * frac) + 1.0) / 2.0 + lam
    if kind == "equal":
        return (1.0 + lam) / 2.0  # constant with the same mean as cosine
    if kind == "linear":
        return (1.0 - lam) * (1.0 - frac) + lam
    raise ValueError(f"unknown schedule kind {kind!r}")


def critical_counts(num_layers: int, num_experts: int, lam: float,
                    kind: str = "cosine") -> Sequence[int]:
    """t_l = ⌈r(l)·M⌉ per layer (Eq. 5), as host Python ints."""
    return tuple(
        max(1, min(num_experts,
                   math.ceil(retention_ratio(l, num_layers, lam, kind)
                             * num_experts)))
        for l in range(num_layers)
    )

