"""Containers for quantized and mixed-precision weights."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.quant.quantize import dequantize_tensor, quantize_tensor

__all__ = ["QuantizedTensor", "MixedPrecisionWeights"]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """A bit-packed group-wise-quantized weight.

    packed: uint8 (..., N, K // values_per_byte)
    scales: float32 (..., K // group_size, N)
    """

    packed: torch.Tensor
    scales: torch.Tensor
    bits: int
    group_size: int
    k: int

    @classmethod
    def quantize(cls, w: torch.Tensor, bits: int,
                 group_size: int) -> "QuantizedTensor":
        packed, scales = quantize_tensor(w, bits, group_size)
        return cls(packed=packed, scales=scales, bits=bits,
                   group_size=group_size, k=w.shape[-2])

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The dense (..., K, N) weight (tests and oracles only: the serving
        paths run the codes through the kernels)."""
        return dequantize_tensor(self.packed, self.scales, self.bits,
                                 self.group_size, dtype)

    def index(self, i) -> "QuantizedTensor":
        """The slice ``[i]`` of every leading-stacked leaf (a layer)."""
        return dataclasses.replace(self, packed=self.packed[i],
                                   scales=self.scales[i])


@dataclasses.dataclass(frozen=True)
class MixedPrecisionWeights:
    """High- and low-precision variants of the same weight. ``low`` is
    None for a "4/0" deployment where sub-critical experts are skipped."""

    high: QuantizedTensor
    low: Optional[QuantizedTensor]

    @classmethod
    def build(cls, w: torch.Tensor, high_bits: int = 4,
              low_bits: Optional[int] = 2,
              group_size: int = 64) -> "MixedPrecisionWeights":
        high = QuantizedTensor.quantize(w, high_bits, group_size)
        low = (QuantizedTensor.quantize(w, low_bits, group_size)
               if low_bits else None)
        return cls(high=high, low=low)

    def index(self, i) -> "MixedPrecisionWeights":
        return MixedPrecisionWeights(
            high=self.high.index(i),
            low=self.low.index(i) if self.low is not None else None)
