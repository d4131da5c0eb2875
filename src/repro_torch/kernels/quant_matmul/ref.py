"""Plain PyTorch versions of the packed-weight matmul kernels (torch twin
of ``repro/kernels/quant_matmul/ref.py``; the expert ones are written
batched: the JAX package's ``custom_vmap`` row oracles exist only because
it vmaps decode over slots, and the port writes the slot batch out
instead).

Each expert is streamed on its own — its codes dequantized to f32 and
dotted with x widened to f32 — so no dense (E, K, N) weight is built.
These are what a CPU tensor runs, what the tests hold against the JAX
package, and what ``chip_smoke.py`` holds the CUDA kernels against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.quantize import dequantize_tensor

__all__ = ["quant_matmul_ref", "expert_quant_matmul_ref", "expert_quant_matmul_fixed_ref",
           "expert_quant_matmul_grouped_ref"]


def _mm(xe: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
        bits: int, group_size: int) -> torch.Tensor:
    w = dequantize_tensor(packed, scales, bits, group_size, torch.float32)
    return xe.to(torch.float32) @ w


def quant_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, *, bits: int, group_size: int,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain K3: ``y = x @ dequant(W)``. x (M, K); packed (N, K/vpb);
    scales (K/gs, N). Dequantized to f32, x widened to f32, f32 matmul."""
    return _mm(x, packed, scales, bits, group_size).to(out_dtype)


def expert_quant_matmul_ref(
        x: torch.Tensor, hi_packed: torch.Tensor, hi_scales: torch.Tensor,
        lo_packed: Optional[torch.Tensor], lo_scales: Optional[torch.Tensor],
        critical: torch.Tensor, *, hi_bits: int, lo_bits: int,
        group_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain K2: ``y[e] = x[e] @ W_e`` at per-expert precision.
    x (E, M, K); *_packed (E, N, K/vpb); *_scales (E, K/gs, N);
    critical (E,). ``lo_packed is None`` zeroes sub-critical experts.
    Both precisions are computed and selected on the device, so the mask
    is never read on the host."""
    crit = critical.reshape(-1) > 0
    ys = []
    for e in range(x.shape[0]):
        y_hi = _mm(x[e], hi_packed[e], hi_scales[e], hi_bits, group_size)
        if lo_packed is None:
            y_lo = torch.zeros_like(y_hi)
        else:
            y_lo = _mm(x[e], lo_packed[e], lo_scales[e], lo_bits, group_size)
        ys.append(torch.where(crit[e], y_hi, y_lo))
    return torch.stack(ys).to(out_dtype)


def expert_quant_matmul_fixed_ref(
        x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
        bits: int, group_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Every expert at one fixed precision: x (E, M, K) -> (E, M, N)."""
    return torch.stack([_mm(x[e], packed[e], scales[e], bits, group_size)
                        for e in range(x.shape[0])]).to(out_dtype)


def expert_quant_matmul_grouped_ref(
        x: torch.Tensor, hi_packed: torch.Tensor, hi_scales: torch.Tensor,
        lo_packed: Optional[torch.Tensor], lo_scales: Optional[torch.Tensor],
        counts: Optional[torch.Tensor] = None, *, cap_hi: int, hi_bits: int,
        lo_bits: int, group_size: int,
        out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain K1 over one combined capacity buffer: hi slots in
    ``[0, cap_hi)``, lo slots in ``[cap_hi, M)``. ``counts`` (E, 2) are
    the per-(expert, precision) live-row watermarks: rows at or past them
    come back exactly zero, as the kernel writes them (``None`` = fully
    occupied). Under "4/0" ``cap_hi == M``."""
    e_, m, _ = x.shape
    if lo_packed is None:
        assert cap_hi == m, (cap_hi, m)
    ys = []
    for e in range(e_):
        parts = [_mm(x[e, :cap_hi], hi_packed[e], hi_scales[e], hi_bits,
                     group_size)]
        if lo_packed is not None:
            parts.append(_mm(x[e, cap_hi:], lo_packed[e], lo_scales[e],
                             lo_bits, group_size))
        ys.append(torch.cat(parts, dim=0))
    y = torch.stack(ys)
    if counts is not None:
        rows = torch.arange(m, device=x.device)
        in_lo = rows >= cap_hi
        caps = torch.tensor([cap_hi, m - cap_hi], device=x.device)
        wm = torch.minimum(counts.to(torch.int64).clamp(min=0),
                           caps[None, :])                  # (E, 2)
        limit = torch.where(in_lo[None, :], cap_hi + wm[:, 1:2],
                            wm[:, 0:1])                    # (E, M)
        y = torch.where((rows[None, :] < limit)[..., None], y,
                        torch.zeros((), dtype=y.dtype, device=y.device))
    return y.to(out_dtype)
