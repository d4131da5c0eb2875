"""The single entry point for every mixed-precision matmul in the model
(torch twin of ``repro/quant/mixed.py``): ``y = x @ W`` at the precision
``critical`` selects, straight from the packed codes through
``expert_quant_matmul`` — no dense dequantized weight is built."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant.qtensor import MixedPrecisionWeights

__all__ = ["mixed_precision_matmul"]


def mixed_precision_matmul(x: torch.Tensor, mp: MixedPrecisionWeights,
                           critical, *, skip_to_zero: bool = True,
                           out_dtype=None) -> torch.Tensor:
    """Two weight layouts:
      * expert-batched — ``mp.high.packed`` is (E, N, K/vpb), ``x`` is
        (E, M, K), ``critical`` is (E,): the MoE expert FFN;
      * dense — ``mp.high.packed`` is (N, K/vpb), ``x`` is (..., K),
        ``critical`` a scalar (a host bool, or a tensor): lifted to a
        1-expert group, so K2 runs it with E = 1 and M the rows of x.

    ``skip_to_zero`` is the "x/0" policy when ``mp.low is None``: True
    zeroes sub-critical experts (MoE), False runs high always (dense)."""
    from repro_torch.kernels.quant_matmul.ops import expert_quant_matmul

    if out_dtype is None:
        out_dtype = x.dtype
    batched = mp.high.packed.dim() == 3
    if mp.low is None and not skip_to_zero:
        e = mp.high.packed.shape[0] if batched else 1
        critical = torch.ones((e,), dtype=torch.int32, device=x.device)
    if batched:
        return expert_quant_matmul(x, mp, critical, out_dtype=out_dtype)
    lead = x.shape[:-1]
    x3 = x.reshape(1, -1, x.shape[-1])
    if isinstance(critical, torch.Tensor):
        crit = critical.to(x.device).reshape(1)
    else:   # a host flag: a fill kernel, no host-to-device copy (capturable)
        crit = torch.full((1,), int(critical), dtype=torch.int32,
                          device=x.device)
    mp1 = MixedPrecisionWeights(
        high=_lift(mp.high),
        low=_lift(mp.low) if mp.low is not None else None)
    y = expert_quant_matmul(x3, mp1, crit, out_dtype=out_dtype)
    return y.reshape(*lead, -1)


def _lift(qt):
    """Add a leading 1-expert dim to a dense QuantizedTensor."""
    return dataclasses.replace(qt, packed=qt.packed[None],
                               scales=qt.scales[None])
