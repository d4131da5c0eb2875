"""Products over split weights, with the collectives placed by hand — the
port's stand-in for what GSPMD inserts into the JAX package's programs
under a mesh.

A weight is either a whole tensor (every rank holds all of it: no spec
split it, or the guard degraded the split) or a :class:`Shard` (this rank
holds one block of one dim). Activations are always whole on every rank;
the ranks compute them bitwise alike (an ``all_reduce`` leaves the same
bits on every rank), so every host decision made from them agrees.

  * column split (the output dim): the local product, then an exact
    gather of the output (:meth:`Mesh.all_gather`);
  * row split (the reduction dim): the local partial product over this
    rank's block of the input, then ``all_reduce`` SUM — the one place a
    sum's order differs from one device's;
  * a Megatron pair (column-split in, row-split out: the dense FFN, the
    shared experts): the input product stays local and ONE SUM ends it;
  * quantized stores split along N run their kernel on the local rows
    and gather the output; split along E (expert-parallel), each rank
    runs only its experts (``models/layers/moe.py``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.sharding.partition import Shard

__all__ = ["local", "cols_split", "rows_split", "matmul", "to_down",
           "from_down", "project_many", "embed", "lm_head", "local_mp",
           "mp_split", "mp_mesh"]


def local(w):
    """The tensor this rank computes with (its block, or the whole)."""
    return w.local if isinstance(w, Shard) else w


def cols_split(w) -> bool:
    """Whether ``w`` (…, K, N) is split along its output dim N."""
    return isinstance(w, Shard) and w.dim == w.local.dim() - 1


def rows_split(w) -> bool:
    """Whether ``w`` (…, K, N) is split along its reduction dim K."""
    return isinstance(w, Shard) and w.dim == w.local.dim() - 2


def to_down(h: torch.Tensor, w_in, w_out) -> torch.Tensor:
    """``h``, made by the in-products of an FFN pair over ``w_in`` (float
    or quantized), in the layout ``w_out``'s reduction dim reads: kept as
    this rank's block when both float weights are split (the Megatron
    pair), gathered or sliced when one is; a quantized store is split
    along N only, so its K reads ``h`` whole."""
    if isinstance(w_in, MixedPrecisionWeights):
        return mp_mesh(w_in).all_gather(h, -1) if mp_split(w_in) == "n" \
            else h
    if cols_split(w_in):
        return h if rows_split(w_out) else w_in.mesh.all_gather(h, -1)
    if rows_split(w_out):
        lo, hi = w_out.block()
        return h[..., lo:hi]
    return h


def from_down(y: torch.Tensor, w_out) -> torch.Tensor:
    """The out-product over ``w_out`` whole on every rank: summed over
    the ranks when a float ``w_out`` is row-split, gathered when a
    quantized one is split along N."""
    if isinstance(w_out, MixedPrecisionWeights):
        return mp_mesh(w_out).all_gather(y, -1) if mp_split(w_out) == "n" \
            else y
    return w_out.mesh.all_reduce(y, "sum") if rows_split(w_out) else y


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` whole on every rank, whichever way ``w`` is split."""
    if cols_split(w):
        return w.mesh.all_gather(x @ w.local, -1)
    if rows_split(w):
        lo, hi = w.block()
        return w.mesh.all_reduce(x[..., lo:hi] @ w.local, "sum")
    return x @ w


def project_many(x: torch.Tensor, ws: Sequence,
                 biases: Optional[Sequence] = None) -> List[torch.Tensor]:
    """``x @ w (+ b)`` for each ``w`` in ``ws``, whole on every rank; when
    every ``w`` is column-split (its bias then split alike) the local
    outputs are gathered through ONE collective (attention's q, k, v)."""
    biases = list(biases) if biases is not None else [None] * len(ws)
    if all(cols_split(w) for w in ws):
        outs = [x @ w.local if b is None else x @ w.local + local(b)
                for w, b in zip(ws, biases)]
        return ws[0].mesh.all_gather_many(outs, -1)
    return [matmul(x, w) if b is None else matmul(x, w) + b
            for w, b in zip(ws, biases)]


def embed(table, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` with the (V, dm) table whole or split along dm."""
    if isinstance(table, Shard):
        assert table.dim == 1, table
        return table.mesh.all_gather(table.local[tokens], -1)
    return table[tokens]


def lm_head(x: torch.Tensor, w, tied: bool) -> torch.Tensor:
    """``x @ w`` (``w`` the (dm, V) head) or, tied, ``x @ embed.T`` with
    the (V, dm) table; a dm split is a row split of the head."""
    if not tied:
        return matmul(x, w)
    if isinstance(w, Shard):
        assert w.dim == 1, w
        lo, hi = w.block()
        return w.mesh.all_reduce(x[..., lo:hi] @ w.local.T, "sum")
    return x @ w.T


# ---------------------------------------------------------- quantized


def mp_split(mp: MixedPrecisionWeights) -> Optional[str]:
    """How a quantized store is split: "n" (its N dim: the packed rows),
    "e" (its expert dim, expert-parallel) or None (whole)."""
    p = mp.high.packed
    if not isinstance(p, Shard):
        return None
    nd = p.local.dim()
    if p.dim == nd - 2:
        return "n"
    if p.dim == nd - 3:
        return "e"
    raise ValueError(f"unexpected split of a quantized store: {p!r}")


def mp_mesh(mp: MixedPrecisionWeights):
    return mp.high.packed.mesh


def _local_qt(qt: Optional[QuantizedTensor]) -> Optional[QuantizedTensor]:
    if qt is None:
        return None
    packed, scales = qt.packed, qt.scales
    if isinstance(packed, Shard) != isinstance(scales, Shard):
        raise ValueError("a quantized store's packed codes and scales must "
                         "be split alike")
    return QuantizedTensor(packed=local(packed), scales=local(scales),
                           bits=qt.bits, group_size=qt.group_size, k=qt.k)


def local_mp(mp: MixedPrecisionWeights) -> MixedPrecisionWeights:
    """The store's local block as a plain ``MixedPrecisionWeights`` (the
    kernels' argument)."""
    if mp_split(mp) is None:
        return mp
    return MixedPrecisionWeights(high=_local_qt(mp.high),
                                 low=_local_qt(mp.low))
