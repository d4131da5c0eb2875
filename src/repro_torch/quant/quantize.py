"""Group-wise symmetric RTN quantization (torch twin of
``repro/quant/quantize.py``).

Weights are ``(..., K, N)`` with K the reduction axis of ``y = x @ w``.
Each group of ``group_size`` consecutive K rows shares one f32 scale per
output column. ``quantize_tensor`` packs along K after swapping the
trailing axes, so the packed store is ``(..., N, K / values_per_byte)``
with K contiguous for each output column.
"""
from __future__ import annotations

import torch

from repro_torch.quant.packing import pack_bits, unpack_bits

__all__ = ["quantize_groupwise", "dequantize_groupwise", "quantize_tensor",
           "dequantize_tensor", "gptq_lite_quantize"]


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1  # 127 / 7 / 1


def quantize_groupwise(w: torch.Tensor, bits: int, group_size: int):
    """Returns int8 codes (..., K, N) and f32 scales (..., K/gs, N)."""
    *lead, k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    g = k // group_size
    qmax = _qmax(bits)
    wg = w.reshape(*lead, g, group_size, n).to(torch.float32)
    absmax = wg.abs().amax(dim=-2, keepdim=True)            # (..., g, 1, n)
    scales = absmax / qmax
    safe = torch.where(scales == 0.0, torch.ones_like(scales), scales)
    # parity: torch.round and jnp.round both round half to even
    q = torch.clamp(torch.round(wg / safe), -qmax - 1, qmax).to(torch.int8)
    return q.reshape(*lead, k, n), scales.squeeze(-2)


def dequantize_groupwise(q: torch.Tensor, scales: torch.Tensor,
                         group_size: int,
                         dtype=torch.bfloat16) -> torch.Tensor:
    *lead, k, n = q.shape
    g = k // group_size
    qg = q.reshape(*lead, g, group_size, n).to(torch.float32)
    w = qg * scales[..., :, None, :]
    return w.reshape(*lead, k, n).to(dtype)


def quantize_tensor(w: torch.Tensor, bits: int, group_size: int):
    """RTN quantize + bit-pack along K. Returns (packed uint8
    (..., N, K/vpb), scales f32 (..., K/gs, N))."""
    q, scales = quantize_groupwise(w, bits, group_size)
    packed = pack_bits(q.transpose(-1, -2), bits)           # (..., N, K/vpb)
    return packed.contiguous(), scales.contiguous()


def dequantize_tensor(packed: torch.Tensor, scales: torch.Tensor, bits: int,
                      group_size: int, dtype=torch.bfloat16) -> torch.Tensor:
    q = unpack_bits(packed, bits).transpose(-1, -2)         # (..., K, N)
    return dequantize_groupwise(q, scales, group_size, dtype)


def gptq_lite_quantize(w: torch.Tensor, bits: int, group_size: int,
                       n_iter: int = 8):
    """Zero-calibration refinement over absmax RTN: a per-group scale
    grid search (MSE-optimal clipping, GPTQ's identity-Hessian special
    case; the paper's no-calibration constraint rules out a data-dependent
    Hessian). The absmax scale (factor 1.0) is in the grid, so the result
    is never worse than RTN in group MSE. ``n_iter`` sets the grid's
    resolution (factors 1.0 down to 0.5).

    Returns int8 codes (..., K, N) and f32 scales (..., K/gs, N), the
    layout of :func:`quantize_groupwise`."""
    *lead, k, n = w.shape
    g = k // group_size
    qmax = _qmax(bits)
    wg = w.to(torch.float32).reshape(*lead, g, group_size, n)
    base = wg.abs().amax(dim=-2, keepdim=True) / qmax
    best_err = torch.full_like(base, float("inf"))
    best_q = torch.zeros(wg.shape, dtype=torch.int8, device=w.device)
    best_s = base
    for i in range(n_iter):
        factor = 1.0 - 0.5 * i / max(n_iter - 1, 1)      # 1.0 ... 0.5
        s = base * factor
        safe = torch.where(s == 0.0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(wg / safe), -qmax - 1, qmax)
        err = ((q * s - wg) ** 2).sum(dim=-2, keepdim=True)
        take = err < best_err
        best_err = torch.where(take, err, best_err)
        best_s = torch.where(take, s, best_s)
        best_q = torch.where(take, q, best_q.to(torch.float32)) \
            .to(torch.int8)
    return best_q.reshape(*lead, k, n), best_s.squeeze(-2)
