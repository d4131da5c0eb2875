"""Weights carried across from the JAX package.

``from_reference(tree, device)`` turns the JAX package's params or
qparams — given as nested dicts of numpy arrays — into the port's: numpy
arrays become tensors on ``device`` (``None`` means CUDA, and raises where
there is none: pass ``"cpu"`` for the CPU; bf16 arrives as numpy's ``bfloat16``
extension dtype or as a uint16 view, and is reinterpreted bit for bit), a
``QuantizedTensor`` arrives as ``{packed, scales, bits, group_size, k}``
and a ``MixedPrecisionWeights`` as ``{high, low}``. Stacked leading L dims
are kept as they are.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor

__all__ = ["from_reference", "tensor_from_numpy"]

_QT_KEYS = {"packed", "scales", "bits", "group_size", "k"}


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def from_reference(tree: Any, device=None) -> Any:
    device = resolve_device(device)
    if isinstance(tree, dict):
        if set(tree) == _QT_KEYS:
            return QuantizedTensor(
                packed=tensor_from_numpy(tree["packed"], device),
                scales=tensor_from_numpy(tree["scales"], device),
                bits=int(tree["bits"]), group_size=int(tree["group_size"]),
                k=int(tree["k"]))
        if set(tree) == {"high", "low"}:
            low = tree["low"]
            return MixedPrecisionWeights(
                high=from_reference(tree["high"], device),
                low=None if low is None else from_reference(low, device))
        return {k: from_reference(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        return tensor_from_numpy(np.asarray(tree), device)
    raise TypeError(f"from_reference: unsupported leaf {type(tree)!r}")
