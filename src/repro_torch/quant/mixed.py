"""The single entry point for every mixed-precision matmul in the model
(torch twin of ``repro/quant/mixed.py``): ``y = x @ W`` at the precision
``critical`` selects, straight from the packed codes through
``expert_quant_matmul`` — no dense dequantized weight is built.

``materialize=True`` keeps the dequantize-and-select semantics as an
escape hatch for tests and oracles (:func:`select_mixed_weights` is that
materializing select on its own); no serving path takes it."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.quant.qtensor import MixedPrecisionWeights

__all__ = ["mixed_precision_matmul", "select_mixed_weights"]


def select_mixed_weights(mp: MixedPrecisionWeights, critical, dtype, *,
                         skip_to_zero: bool = True) -> torch.Tensor:
    """Materializing per-expert precision select (tests/oracles only).

    critical: (E,) bool for expert-batched weights, scalar for dense ones.
    ``skip_to_zero`` is the ``low is None`` ("x/0") policy: True zeroes
    sub-critical experts (MoE: a zero expert contributes nothing), False
    keeps high (dense: skipping would ablate the whole layer)."""
    hi = mp.high.dequantize(dtype)
    c = torch.as_tensor(critical, device=hi.device)
    cmask = c.reshape(c.shape + (1,) * (hi.dim() - c.dim())).to(torch.bool)
    if mp.low is None:
        if not skip_to_zero:
            return hi
        return torch.where(cmask, hi, torch.zeros_like(hi))
    return torch.where(cmask, hi, mp.low.dequantize(dtype))


def mixed_precision_matmul(x: torch.Tensor, mp: MixedPrecisionWeights,
                           critical, *, skip_to_zero: bool = True,
                           materialize: bool = False,
                           out_dtype=None) -> torch.Tensor:
    """Two weight layouts:
      * expert-batched — ``mp.high.packed`` is (E, N, K/vpb), ``x`` is
        (E, M, K), ``critical`` is (E,): the MoE expert FFN;
      * dense — ``mp.high.packed`` is (N, K/vpb), ``x`` is (..., K),
        ``critical`` a scalar (a host bool, or a tensor): lifted to a
        1-expert group, so K2 runs it with E = 1 and M the rows of x.

    ``skip_to_zero`` is the "x/0" policy when ``mp.low is None``: True
    zeroes sub-critical experts (MoE), False runs high always (dense).
    ``materialize`` dequantizes the selected weight and runs a plain
    product instead (:func:`select_mixed_weights`; tests and oracles)."""
    from repro_torch.kernels.quant_matmul.ops import expert_quant_matmul

    if out_dtype is None:
        out_dtype = x.dtype
    batched = mp.high.packed.dim() == 3
    if materialize:
        w = select_mixed_weights(mp, critical, x.dtype,
                                 skip_to_zero=skip_to_zero)
        eq = "emk,ekn->emn" if batched else "...k,kn->...n"
        return torch.einsum(eq, x, w).to(out_dtype)
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
