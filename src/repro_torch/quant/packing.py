"""Bit-packing for sub-byte integer weights (torch twin of
``repro/quant/packing.py``).

Values are signed integers in ``[-2^(b-1), 2^(b-1) - 1]`` stored
offset-coded as unsigned ``v + 2^(b-1)`` and packed along the LAST axis
into uint8 lanes: ``bits=4`` packs 2 values/byte, ``bits=2`` packs 4,
``bits=8`` is a plain offset-coded uint8. Value ``j`` of a byte sits at
bit ``bits * j`` — the layout the CUDA kernels unpack.
"""
from __future__ import annotations

import torch

__all__ = ["pack_bits", "unpack_bits", "packed_dim", "values_per_byte"]


def values_per_byte(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bit width: {bits}")
    return 8 // bits


def packed_dim(k: int, bits: int) -> int:
    """Size of the trailing axis after packing ``k`` values at ``bits``."""
    vpb = values_per_byte(bits)
    if k % vpb != 0:
        raise ValueError(f"trailing dim {k} not divisible by {vpb} for int{bits}")
    return k // vpb


def pack_bits(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed ints (any int dtype) into uint8 along the last axis."""
    vpb = values_per_byte(bits)
    offset = 1 << (bits - 1)
    u = (values.to(torch.int32) + offset).to(torch.uint8)
    if bits == 8:
        return u
    *lead, k = u.shape
    if k % vpb != 0:
        raise ValueError(f"trailing dim {k} not divisible by {vpb}")
    u = u.reshape(*lead, k // vpb, vpb)
    out = torch.zeros((*lead, k // vpb), dtype=torch.uint8, device=u.device)
    for j in range(vpb):
        out |= u[..., j] << (bits * j)
    return out


def unpack_bits(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns int8 in [-2^(b-1), 2^(b-1)-1]."""
    offset = 1 << (bits - 1)
    if bits == 8:
        return (packed.to(torch.int32) - offset).to(torch.int8)
    vpb = values_per_byte(bits)
    mask = (1 << bits) - 1
    u = torch.stack([(packed >> (bits * j)) & mask for j in range(vpb)],
                    dim=-1)                         # (..., k/vpb, vpb)
    u = u.reshape(*packed.shape[:-1], packed.shape[-1] * vpb)
    return (u.to(torch.int32) - offset).to(torch.int8)
