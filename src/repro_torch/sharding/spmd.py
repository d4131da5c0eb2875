"""Products over split weights, with the collectives placed by hand — the
port's stand-in for what GSPMD inserts into the JAX package's programs
under a mesh.

A weight is either a whole tensor (every rank holds all of it: no spec
split it, or the guard degraded the split) or a :class:`Shard` (this rank
holds one block of one dim, split over "model"). Activations hold the
rows of this rank's batch block (``Mesh.for_batch``) and are whole along
every other dim; the ranks of one "model" sub-group hold the same rows
and compute them bitwise alike (an ``all_reduce`` leaves the same bits on
every rank), so every host decision made from them agrees. Every
collective here runs over the "model" sub-group only (the ``Mesh``
methods' default axis): weights are whole across the data ranks.

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

Under the train step (grads taken) the collectives carry their adjoints
(``launch/mesh.py``), and an input whole on every rank passes through
:meth:`Mesh.enter` where a rank starts computing on its block of it (the
input of a column split, this rank's slice for a row split): its
backward sums the ranks' partial grads of the input, so the grads of
every tensor whole on the "model" ranks are whole there too. Without
grads ``enter`` is the tensor itself.

The sequence split of the training residual (``cfg.act_seq_shard``):
between blocks a rank holds only its block of the sequence
(:func:`seq_leave`, a fresh copy, no collective; its backward gathers the
ranks' grad blocks), and a block starts by gathering the whole sequence
(:func:`seq_enter`, one exact gather; its backward is this rank's block of
the grad). Blocks are ceil(S / model ranks) positions, the last ones
zero-padded past S and trimmed after the gather, so any S splits.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.sharding.partition import Shard

__all__ = ["local", "cols_split", "rows_split", "enter_cols", "matmul",
           "to_down", "from_down", "project_many", "embed", "lm_head",
           "seq_leave", "seq_enter", "local_mp", "mp_split", "mp_mesh"]


def local(w):
    """The tensor this rank computes with (its block, or the whole)."""
    return w.local if isinstance(w, Shard) else w


def cols_split(w) -> bool:
    """Whether ``w`` (…, K, N) is split along its output dim N."""
    return isinstance(w, Shard) and w.dim == w.local.dim() - 1


def rows_split(w) -> bool:
    """Whether ``w`` (…, K, N) is split along its reduction dim K."""
    return isinstance(w, Shard) and w.dim == w.local.dim() - 2


def enter_cols(x: torch.Tensor, w) -> torch.Tensor:
    """``x`` (whole on every rank) as the input of a product over this
    rank's columns of ``w``: :meth:`Mesh.enter` when a float ``w`` is
    column-split, else ``x``."""
    return w.mesh.enter(x) if cols_split(w) else x


def _slice_for(h: torch.Tensor, w) -> torch.Tensor:
    """This rank's block of ``h`` (whole on every rank) along the
    reduction dim that the row-split ``w`` holds."""
    lo, hi = w.block()
    return w.mesh.enter(h)[..., lo:hi]


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
        return _slice_for(h, w_out)
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
        return w.mesh.all_gather(w.mesh.enter(x) @ w.local, -1)
    if rows_split(w):
        return w.mesh.all_reduce(_slice_for(x, w) @ w.local, "sum")
    return x @ w


def project_many(x: torch.Tensor, ws: Sequence,
                 biases: Optional[Sequence] = None) -> List[torch.Tensor]:
    """``x @ w (+ b)`` for each ``w`` in ``ws``, whole on every rank; when
    every ``w`` is column-split (its bias then split alike) the local
    outputs are gathered through ONE collective (attention's q, k, v)."""
    biases = list(biases) if biases is not None else [None] * len(ws)
    if all(cols_split(w) for w in ws):
        x = ws[0].mesh.enter(x)
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
        return w.mesh.all_reduce(_slice_for(x, w) @ w.local.T, "sum")
    return x @ w.T


# ------------------------------------------------------ sequence split


def seq_leave(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (rows, S, dm), whole on every "model" rank -> this rank's
    block of its sequence (rows, ceil(S / model ranks), dm), a fresh
    contiguous copy (:meth:`Mesh.seq_split`); ``x`` itself on one "model"
    rank."""
    return mesh.seq_split(x, 1)


def seq_enter(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The inverse of :func:`seq_leave`: this rank's block -> the whole
    ``n`` positions on every "model" rank (:meth:`Mesh.seq_gather`)."""
    return mesh.seq_gather(x, n, 1)


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
