"""Public entry points of the packed-weight matmuls (torch twin of
``repro/kernels/quant_matmul/ops.py``).

Dispatch is by the device of ``x`` alone: a CUDA tensor launches the
hand-written kernel (or raises — there is no fallback), a CPU tensor runs
the plain PyTorch version. Nothing else selects the implementation. A
meta tensor (``repro_torch.analysis``, the dry run) gets an empty output
of the plain version's shape and dtype: the plain version's per-expert
loop would cost the full-size trace most of its time and tell it nothing.

Each entry point is one kernel call, inside one
:class:`~repro_torch.kernels._scope.kernel_scope` named by the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels._scope import kernel_scope
from repro_torch.kernels.quant_matmul import ref
from repro_torch.kernels.quant_matmul.expert_quant_matmul import \
    expert_quant_matmul_cuda, expert_quant_matmul_grouped_cuda
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul_cuda
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor

__all__ = ["quant_matmul", "expert_quant_matmul", "expert_quant_matmul_fixed",
           "expert_quant_matmul_grouped"]


def quant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """``y = x @ dequant(qt)`` with x of shape (..., K) -> (..., N)."""
    with kernel_scope("quant_matmul", x, qt.packed, qt.scales) as ks:
        lead, k = x.shape[:-1], x.shape[-1]
        if x.is_meta:
            return ks.done(_meta_out(x, (*lead, qt.packed.shape[0]),
                                     out_dtype))
        x2 = x.reshape(-1, k)
        kw = dict(bits=qt.bits, group_size=qt.group_size,
                  out_dtype=out_dtype)
        if not on_cuda(x):
            y = ref.quant_matmul_ref(x2, qt.packed, qt.scales, **kw)
        else:
            y = quant_matmul_cuda(x2.contiguous(), qt.packed, qt.scales,
                                  **kw)
        return ks.done(y.reshape(*lead, -1))


def _meta_out(x: torch.Tensor, shape, dtype) -> torch.Tensor:
    """What a kernel returns on the meta device: its shape and dtype."""
    return torch.empty(shape, dtype=dtype, device=x.device)


def expert_quant_matmul_grouped(x: torch.Tensor,
                                weights: MixedPrecisionWeights,
                                counts: Optional[torch.Tensor] = None, *,
                                cap_hi: int,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """ONE fused dispatch for the dual-buffer per-row MoE: ``x`` (E, M, K)
    holds the hi region ``[0, cap_hi)`` and the lo region ``[cap_hi, M)``
    of every expert; ``counts`` (E, 2) int32 live-row watermarks (None =
    fully occupied). Under "4/0" ``cap_hi == M``. Returns (E, M, N)."""
    hi, lo = weights.high, weights.low
    with kernel_scope("expert_quant_matmul_grouped", x, hi.packed, hi.scales,
                      lo and lo.packed, lo and lo.scales, counts,
                      cap_hi=cap_hi) as ks:
        return ks.done(_grouped(x, hi, lo, counts, cap_hi, out_dtype))


def _grouped(x, hi, lo, counts, cap_hi, out_dtype):
    if lo is not None:
        assert lo.group_size == hi.group_size, (lo.group_size, hi.group_size)
    e, m, _ = x.shape
    assert (lo is None) == (cap_hi == m), (cap_hi, m, lo is None)
    if x.is_meta:
        return _meta_out(x, (e, m, hi.packed.shape[1]), out_dtype)
    kw = dict(cap_hi=cap_hi, hi_bits=hi.bits,
              lo_bits=lo.bits if lo is not None else 0,
              group_size=hi.group_size, out_dtype=out_dtype)
    lo_p = lo.packed if lo is not None else None
    lo_s = lo.scales if lo is not None else None
    if not on_cuda(x):
        return ref.expert_quant_matmul_grouped_ref(
            x, hi.packed, hi.scales, lo_p, lo_s, counts, **kw)
    if counts is None:
        counts = torch.stack(
            [torch.full((e,), cap_hi, dtype=torch.int32, device=x.device),
             torch.full((e,), m - cap_hi, dtype=torch.int32,
                        device=x.device)], dim=1)
    return expert_quant_matmul_grouped_cuda(
        x.contiguous(), hi.packed, hi.scales, lo_p, lo_s,
        counts.to(torch.int32).contiguous(), **kw)


def expert_quant_matmul(x: torch.Tensor, weights: MixedPrecisionWeights,
                        critical: torch.Tensor, *,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """``y[e] = x[e] @ W_e`` at the precision ``critical`` (E,) picks per
    expert; ``weights.low is None`` zeroes sub-critical experts."""
    hi, lo = weights.high, weights.low
    with kernel_scope("expert_quant_matmul", x, hi.packed, hi.scales,
                      lo and lo.packed, lo and lo.scales, critical) as ks:
        return ks.done(_expert(x, hi, lo, critical, out_dtype))


def _expert(x, hi, lo, critical, out_dtype):
    if lo is not None:
        assert lo.group_size == hi.group_size, (lo.group_size, hi.group_size)
    e = hi.packed.shape[0]
    critical = torch.as_tensor(critical, device=x.device)
    assert critical.shape == (e,), \
        f"critical mask shape {tuple(critical.shape)} != ({e},) experts"
    if x.is_meta:
        return _meta_out(x, (e, x.shape[1], hi.packed.shape[1]), out_dtype)
    kw = dict(hi_bits=hi.bits, lo_bits=lo.bits if lo is not None else 0,
              group_size=hi.group_size, out_dtype=out_dtype)
    lo_p = lo.packed if lo is not None else None
    lo_s = lo.scales if lo is not None else None
    if not on_cuda(x):
        return ref.expert_quant_matmul_ref(x, hi.packed, hi.scales, lo_p,
                                           lo_s, critical, **kw)
    return expert_quant_matmul_cuda(
        x.contiguous(), hi.packed, hi.scales, lo_p, lo_s,
        critical.to(torch.int32).contiguous(), **kw)


def expert_quant_matmul_fixed(x: torch.Tensor, qt: QuantizedTensor, *,
                              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Every expert at ``qt``'s one precision — the per-buffer entry point
    of the two-dispatch (``fused=False``) oracle path. On CUDA it is K2
    with an all-critical mask, as in the JAX package."""
    with kernel_scope("expert_quant_matmul", x, qt.packed, qt.scales) as ks:
        return ks.done(_fixed(x, qt, out_dtype))


def _fixed(x, qt, out_dtype):
    e = qt.packed.shape[0]
    if x.is_meta:
        return _meta_out(x, (e, x.shape[1], qt.packed.shape[1]), out_dtype)
    if not on_cuda(x):
        return ref.expert_quant_matmul_fixed_ref(
            x, qt.packed, qt.scales, bits=qt.bits, group_size=qt.group_size,
            out_dtype=out_dtype)
    return expert_quant_matmul_cuda(
        x.contiguous(), qt.packed, qt.scales, None, None,
        torch.ones((e,), dtype=torch.int32, device=x.device),
        hi_bits=qt.bits, lo_bits=0, group_size=qt.group_size,
        out_dtype=out_dtype)
