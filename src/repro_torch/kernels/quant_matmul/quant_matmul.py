"""Launch wrapper of the hand-written Hopper kernel for the dense packed
matmul, beside its plain PyTorch version.

K3 ``quant_matmul_cuda`` (``csrc/quant_matmul.cu``) replaces
``quant_matmul_pallas`` (``repro/kernels/quant_matmul/quant_matmul.py``);
its plain version is
:func:`~repro_torch.kernels.quant_matmul.ref.quant_matmul_ref`. The kernel
is a body over the tensor-core block routine of K1 and K2
(``csrc/mma_tile.cuh``) with one store and no mask: exact bf16
``mma.sync`` on the integer codes, group scales on f32 partial sums, row
tiles of 64 for a prefill and of 16 for at most 16 rows, where K splits
over a thread block cluster until every SM has a block (the splits' sums
added in a fixed order in shared memory: one launch, no workspace).

The wrapper checks device, dtype, shape and contiguity, allocates its
output with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch is refused, and adds one to
``LAUNCHES["quant_matmul"]`` per launch and nowhere else.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels._build import load, raise_on_error
from repro_torch.kernels.quant_matmul import ref
from repro_torch.kernels.quant_matmul.expert_quant_matmul import _DT, \
    _check_common, _check_store

__all__ = ["quant_matmul_cuda", "LAUNCHES", "reset_launch_counts", "PLAIN"]

LAUNCHES: Dict[str, int] = {"quant_matmul": 0}

# the kernel's plain PyTorch version (what a CPU tensor runs)
PLAIN = {"quant_matmul": ref.quant_matmul_ref}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def quant_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                      scales: torch.Tensor, *, bits: int, group_size: int,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """K3: ``y = x @ dequant(packed, scales)``; x (M, K) f32 or bf16,
    packed (N, K/vpb) uint8, scales (K/gs, N) f32 -> (M, N) out_dtype."""
    name = "quant_matmul"
    if x.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"{name}: x must be (M, K) and packed (N, K/vpb)")
    _check_common(name, x[None], out_dtype, group_size)
    m, k = x.shape
    n = packed.shape[0]
    _check_store(name, packed[None], scales[None], 1, n, k, bits, group_size,
                 x.device)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = load("qm_dense")(
        x.data_ptr(), _DT[x.dtype], packed.data_ptr(), scales.data_ptr(),
        out.data_ptr(), _DT[out_dtype], m, k, n, bits, group_size,
        torch.cuda.current_stream(x.device).cuda_stream)
    raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out
