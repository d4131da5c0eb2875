"""Launch wrappers of the hand-written Hopper kernels for the two packed
expert matmuls, beside their plain PyTorch versions.

* K1 ``expert_quant_matmul_grouped_cuda`` (``csrc/expert_quant_matmul_grouped.cu``)
  replaces ``expert_quant_matmul_grouped_pallas``
  (``repro/kernels/quant_matmul/expert_quant_matmul.py``); its plain
  version is :func:`~repro_torch.kernels.quant_matmul.ref.expert_quant_matmul_grouped_ref`.
* K2 ``expert_quant_matmul_cuda`` (``csrc/expert_quant_matmul.cu``)
  replaces ``expert_quant_matmul_pallas``; its plain version is
  :func:`~repro_torch.kernels.quant_matmul.ref.expert_quant_matmul_ref`.

Both kernels (and K3, ``quant_matmul.py``) are bodies over one
tensor-core block routine, ``csrc/mma_tile.cuh``: exact bf16 ``mma.sync``
on the integer codes (f32 x as three bf16 planes), group scales applied to
f32 partial sums, codes staged by ``cp.async``. Products are exact; sums
run in another order than the plain version's f32 matmul, so the kernels
agree with it to 5e-4·(1 + |ref|), not bitwise.

Each wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty`` (the kernels write every element, dead rows
as zeros), launches on the current stream without synchronising, raises
if the launch is refused, and adds one to ``LAUNCHES[name]`` per launch
and nowhere else. Watermarks and masks stay on the device: no wrapper
reads them on the host or sizes a grid from them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels._build import load, raise_on_error
from repro_torch.kernels.quant_matmul import ref

__all__ = ["expert_quant_matmul_grouped_cuda", "expert_quant_matmul_cuda",
           "LAUNCHES", "reset_launch_counts", "PLAIN"]

LAUNCHES: Dict[str, int] = {"expert_quant_matmul_grouped": 0,
                            "expert_quant_matmul": 0}

# each kernel's plain PyTorch version (the same function, computed with
# library ops; what a CPU tensor runs)
PLAIN = {"expert_quant_matmul_grouped": ref.expert_quant_matmul_grouped_ref,
         "expert_quant_matmul": ref.expert_quant_matmul_ref}

_DT = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_store(name, packed, scales, e, n, k, bits, group_size, dev):
    vpb = 8 // bits
    if bits not in (2, 4, 8):
        raise ValueError(f"{name}: unsupported bit width {bits}")
    if packed.dtype != torch.uint8 or packed.shape != (e, n, k // vpb):
        raise ValueError(f"{name}: packed must be uint8 {(e, n, k // vpb)}, "
                         f"got {packed.dtype} {tuple(packed.shape)}")
    if scales.dtype != torch.float32 or \
            scales.shape != (e, k // group_size, n):
        raise ValueError(f"{name}: scales must be float32 "
                         f"{(e, k // group_size, n)}, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    for t in (packed, scales):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: weight store must be contiguous on "
                             f"{dev}")
    if packed.data_ptr() % 4:
        raise ValueError(f"{name}: packed codes must be 4-byte aligned")


def _check_common(name, x, out_dtype, group_size):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if x.dtype not in _DT or out_dtype not in _DT:
        raise ValueError(f"{name}: x/out dtype must be float32 or bfloat16")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (E, M, K) tensor")
    k = x.shape[2]
    # each k16 MMA step must lie inside one scale group (its partial sum
    # takes one scale), and K must hold whole groups
    if group_size % 16 or k % group_size:
        raise ValueError(f"{name}: needs group_size % 16 == 0 and "
                         f"K % group_size == 0 (K={k}, gs={group_size})")


def expert_quant_matmul_grouped_cuda(
        x: torch.Tensor, hi_packed: torch.Tensor, hi_scales: torch.Tensor,
        lo_packed: Optional[torch.Tensor], lo_scales: Optional[torch.Tensor],
        counts: torch.Tensor, *, cap_hi: int, hi_bits: int, lo_bits: int,
        group_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K1: one launch over the combined (E, cap_hi + cap_lo, K) buffer.
    ``counts`` (E, 2) int32 live-row watermarks, read on the device."""
    name = "expert_quant_matmul_grouped"
    _check_common(name, x, out_dtype, group_size)
    e, m, k = x.shape
    n = hi_packed.shape[1]
    has_lo = lo_packed is not None
    if not 0 < cap_hi <= m or has_lo != (cap_hi < m):
        raise ValueError(f"{name}: cap_hi={cap_hi} does not split M={m} "
                         f"(lo store {'present' if has_lo else 'absent'})")
    _check_store(name, hi_packed, hi_scales, e, n, k, hi_bits, group_size,
                 x.device)
    if has_lo:
        _check_store(name, lo_packed, lo_scales, e, n, k, lo_bits,
                     group_size, x.device)
    if counts.dtype != torch.int32 or counts.shape != (e, 2) or \
            counts.device != x.device or not counts.is_contiguous():
        raise ValueError(f"{name}: counts must be contiguous int32 (E, 2) "
                         f"on {x.device}")
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = load("eqm_grouped")(
        x.data_ptr(), _DT[x.dtype], hi_packed.data_ptr(),
        hi_scales.data_ptr(), lo_packed.data_ptr() if has_lo else None,
        lo_scales.data_ptr() if has_lo else None, counts.data_ptr(),
        out.data_ptr(), _DT[out_dtype], e, m, k, n, cap_hi, hi_bits,
        lo_bits if has_lo else 0, group_size,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out


def expert_quant_matmul_cuda(
        x: torch.Tensor, hi_packed: torch.Tensor, hi_scales: torch.Tensor,
        lo_packed: Optional[torch.Tensor], lo_scales: Optional[torch.Tensor],
        critical: torch.Tensor, *, hi_bits: int, lo_bits: int,
        group_size: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """K2: ``y[e] = x[e] @ dequant(critical[e] ? hi_e : lo_e)``;
    ``critical`` (E,) int32, read on the device."""
    name = "expert_quant_matmul"
    _check_common(name, x, out_dtype, group_size)
    e, m, k = x.shape
    n = hi_packed.shape[1]
    has_lo = lo_packed is not None
    _check_store(name, hi_packed, hi_scales, e, n, k, hi_bits, group_size,
                 x.device)
    if has_lo:
        _check_store(name, lo_packed, lo_scales, e, n, k, lo_bits,
                     group_size, x.device)
    if critical.dtype != torch.int32 or critical.shape != (e,) or \
            critical.device != x.device or not critical.is_contiguous():
        raise ValueError(f"{name}: critical must be contiguous int32 (E,) "
                         f"on {x.device}")
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = load("eqm_expert")(
        x.data_ptr(), _DT[x.dtype], hi_packed.data_ptr(),
        hi_scales.data_ptr(), lo_packed.data_ptr() if has_lo else None,
        lo_scales.data_ptr() if has_lo else None, critical.data_ptr(),
        out.data_ptr(), _DT[out_dtype], e, m, k, n, hi_bits,
        lo_bits if has_lo else 0, group_size,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out
