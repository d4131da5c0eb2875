"""RMS normalization (functional)."""
from __future__ import annotations

import torch

__all__ = ["rmsnorm"]


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    y = x * (var + eps) ** -0.5
    return (y * params["scale"].to(torch.float32)).to(dt)
