"""Meshes of ranks for the port's SPMD serving (torch twin of
``repro/launch/mesh.py``).

The JAX package lays its arrays over a ``jax.sharding.Mesh`` of devices
and lets GSPMD partition the jitted programs. The port has no GSPMD: every
rank of a ``torch.distributed`` world runs the same program on its own
shards, and the model code places the collectives by hand. A :class:`Mesh`
is the named shape of that world (``("data", "model")`` or ``("pod",
"data", "model")``), this process's rank and coordinates, and the process
groups of its axes: the "model" sub-group of its batch coordinate, over
which products of split weights reduce, and the "data" sub-group of its
model coordinate, over the composite ("pod", "data") axis a batch is split
over.

Only two collectives are used, ``all_reduce`` (SUM, MAX) and
``broadcast``: gloo, which carries ranks that share one card and the CPU,
offers nothing else for CUDA tensors. :meth:`Mesh.all_gather` is an
``all_reduce`` SUM of a zero-filled buffer in which every position has
exactly one writer, summed as integers over its bytes, so it is exact
(``x + 0 = x``, bit for bit).

A mesh without an initialized world is abstract: enough for the sharding
rules, which read only ``shape``, and for rank 0's program on ``meta``
tensors, whose collectives are shape-only (they count, and add their
payload bytes by kind and by axis, but move nothing; the linter and the
dry run trace the sharded programs so). On a real tensor they need the
world.

Every collective is preceded, by default, by a check that all ranks of
its sub-group are issuing the same one (``check=True``): a tiny MAX over
each rank's (operation, dtype, element count) fingerprint and its
negation. Ranks whose host decisions diverged then raise
``CollectiveMismatch`` together instead of pairing mismatched payloads
(which gloo answers by aborting the process or by blocking until the
timeout). A rank that issues no collective at all is caught by the
process group's timeout.

**Gradients.** The train step computes one global loss: every rank of a
"model" sub-group holds it whole, and each data rank holds the part of it
that its rows give (the data ranks' grads are summed at the end of the
step). The collectives carry adjoints that keep to this, as
``torch.autograd.Function``s, which run only when an input requires grad
(the no-grad path is the in-place one above, unchanged):

  * ``all_reduce`` SUM of partial products: the identity backward (the
    grad of the sum is already whole on every rank);
  * the exact gathers: over "model", this rank's block of the grad; over
    "data", this rank's block of the grad summed over "data" (the gathered
    tensor's grad is each data rank's part);
  * :meth:`Mesh.enter`: the identity forward and a SUM over the axis
    backward, where a tensor whole on every "model" rank starts computing
    on this rank's block (its grad there is this block's part);
  * :meth:`Mesh.count_once`: the identity forward; the backward keeps the
    grad on the axis's first rank only, for a term whole on every data
    rank that enters the summed objective once;
  * the sequence seams: :meth:`Mesh.seq_split` cuts a tensor whole on
    every "model" rank to this rank's block of the sequence with no
    collective, and its backward gathers the ranks' grad blocks;
    :meth:`Mesh.seq_gather` gathers the blocks whole, and its backward is
    this rank's block of the grad.

Backward collectives are counted as forward ones are. The backward works
on copies: ``all_reduce`` writes in place, and a tensor autograd saved
must not change.

Builders are functions, as in the JAX package: importing this module
touches no process group.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "CollectiveMismatch", "make_production_mesh",
           "make_local_mesh", "make_sim_mesh", "spawn", "init_world",
           "DEFAULT_TIMEOUT_S"]

# the process-group timeout of the worlds :func:`spawn` starts: a rank
# left waiting on a collective that another rank never issues raises
# after this long
DEFAULT_TIMEOUT_S = 120.0

_OPS = {"sum": 1, "max": 2, "broadcast": 3}
_KINDS = ("all-reduce", "all-gather", "broadcast")
_AXES = ("model", "data", "world")
_DTYPES = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3,
           torch.float64: 4, torch.int32: 5, torch.int64: 6, torch.uint8: 7}


class CollectiveMismatch(RuntimeError):
    """The ranks of a mesh issued different collectives: their host
    decisions diverged."""


def _new_tally() -> Dict[str, Dict[str, float]]:
    """The collective counters a mesh and its views share, by axis
    ("model", "data" — the composite ("pod", "data") — and "world"):
    payload collectives, their bytes by kind and in all, and seconds."""
    return {a: dict(dict.fromkeys(("collectives",) + _KINDS + ("total",), 0),
                    seconds=0.0) for a in _AXES}


class Mesh:
    """A named grid of ``torch.distributed`` ranks.

    ``shape`` maps axis names to sizes in row-major order (the last axis
    varies fastest over the ranks, as ``jax.make_mesh`` lays devices);
    ``rank`` is this process's rank (None group: the default world, whose
    ranks are the mesh's). A mesh of one rank needs no process group: its
    collectives are the identity. Without an initialized world of its
    size a mesh is abstract — enough for the sharding rules, which read
    only ``shape``, and for meta tensors.

    **Sub-groups.** Over a world, the constructor builds, with
    ``dist.new_group`` called by every rank in the same order, the "model"
    group of each batch coordinate (the ranks that share this rank's
    ("pod", "data") coordinates) and the "data" group of each model
    coordinate (the ranks that share its "model" coordinate, over the
    composite ("pod", "data") axis); an axis that spans the world uses the
    world's group, an axis of size 1 none. So every rank of the world must
    build the same meshes in the same order. ``all_reduce``,
    ``broadcast``, ``all_gather`` and ``all_gather_many`` act over
    ``axis="model"`` by default or ``axis="data"``; the fingerprint check
    runs on the sub-group of the collective it guards. ``agree_float`` and
    ``broadcast_object`` act over the whole world: they carry rank 0's
    host decisions.

    **The batch.** A batch is split in blocks over ("pod", "data")
    (:meth:`batch_block`) when the data ranks divide it, else replicated:
    :meth:`for_batch` gives the mesh a batch runs on, this mesh or its
    :meth:`model_view` (its model sub-group as a mesh of its own, whose
    data axes are 1), over which the model code issues no data collective.

    ``collectives_by_axis`` counts, by axis ("model", "data", "world"),
    the payload collectives, their payload bytes by kind ("all-reduce",
    "all-gather": the gathered buffer, "broadcast") and in all, and their
    seconds (checks and object broadcasts included):
    ``{"collectives": n, <kind>: bytes, ..., "total": bytes, "seconds":
    s}``. ``collectives``, ``collective_s`` and ``collective_bytes`` (as
    ``repro_torch.roofline.collective_bytes_from_mesh`` reads it) are their
    sums over the axes.
    A mesh and its views share the counters. On ``meta`` tensors a
    collective is shape-only (no world is needed).
    """

    def __init__(self, shape: Dict[str, int], rank: int = 0, group=None, *,
                 check: bool = True, _parent: "Mesh" = None):
        self.shape = dict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.group = group
        self.check = check
        self.coords = self._coords_of(rank)
        self.batch_axes: Tuple[str, ...] = tuple(
            a for a in ("pod", "data") if a in self.shape)
        self._views: Dict[str, "Mesh"] = {}
        if _parent is not None:
            # a view: the parent's counters, and its model group for both
            # the model axis and the view's own world
            self._tally = _parent._tally
            model = _parent._groups["model"]
            self._groups = {"model": model, "world": model,
                            "data": (None, 0)}
            return
        self._tally = _new_tally()
        self._groups = {"model": (group, 0), "data": (group, 0),
                        "world": (group, 0)}
        if self.size > 1 and self._in_world():
            self._groups.update(model=self._sub_group(("model",)),
                                data=self._sub_group(self.batch_axes))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    def _coords_of(self, rank: int) -> Dict[str, int]:
        coords: Dict[str, int] = {}
        rest = rank
        for name in reversed(self.axis_names):
            coords[name] = rest % self.shape[name]
            rest //= self.shape[name]
        return {a: coords[a] for a in self.axis_names}

    def _in_world(self) -> bool:
        return (self.group is None and dist.is_available()
                and dist.is_initialized()
                and dist.get_world_size() == self.size)

    def _sub_group(self, axes: Tuple[str, ...]):
        """(process group, global rank of its member at coordinate 0) of
        the ranks that share this rank's coordinates on every axis but
        ``axes``. Every rank creates every such group, in one order."""
        n = 1
        for a in axes:
            n *= self.shape[a]
        if n == 1:
            return (None, self.rank)
        if n == self.size:
            return (None, 0)
        rest = [a for a in self.axis_names if a not in axes]
        groups: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = self._coords_of(r)
            groups.setdefault(tuple(c[a] for a in rest), []).append(r)
        mine = tuple(self.coords[a] for a in rest)
        out = None
        for key in sorted(groups):
            g = dist.new_group(groups[key])
            if key == mine:
                out = (g, groups[key][0])
        return out

    # ----------------------------------------------------------- axes
    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_size(self) -> int:
        """The size of the composite ("pod", "data") batch axis."""
        n = 1
        for a in self.batch_axes:
            n *= self.shape[a]
        return n

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the composite ("pod", "data") axis."""
        r = 0
        for a in self.batch_axes:
            r = r * self.shape[a] + self.coords[a]
        return r

    @property
    def distributed(self) -> bool:
        """Whether collectives leave this process (more than one rank)."""
        return self.size > 1

    def axis_size(self, axis: str) -> int:
        return {"model": self.model_size, "data": self.data_size,
                "world": self.size}[axis]

    def axis_rank(self, axis: str) -> int:
        return {"model": self.model_rank, "data": self.data_rank,
                "world": self.rank}[axis]

    def batch_block(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of an n-row batch: its block when
        the data ranks divide n, else every row (replicated)."""
        d = self.data_size
        if d == 1 or n % d:
            return 0, n
        w = n // d
        return self.data_rank * w, (self.data_rank + 1) * w

    def model_view(self) -> "Mesh":
        """This rank's model sub-group as a mesh of its own (its data axes
        1; the counters shared): what a program that one data coordinate
        runs alone — a replicated batch, or rows that stay on their data
        rank — runs on. The mesh itself when its data axes are 1."""
        if self.data_size == 1:
            return self
        if "model" not in self._views:
            shape = {a: (1 if a in self.batch_axes else n)
                     for a, n in self.shape.items()}
            self._views["model"] = Mesh(shape, self.model_rank,
                                        check=self.check, _parent=self)
        return self._views["model"]

    def for_batch(self, n: int) -> "Mesh":
        """The mesh an n-row batch runs on: this one when the data ranks
        divide n (each computes its :meth:`batch_block`), else the
        :meth:`model_view` (every data rank computes every row)."""
        d = self.data_size
        return self if d == 1 or n % d == 0 else self.model_view()

    # --------------------------------------------------------- counters
    @property
    def collectives(self) -> int:
        return sum(v["collectives"] for v in self._tally.values())

    @property
    def collective_s(self) -> float:
        return sum(v["seconds"] for v in self._tally.values())

    @property
    def collective_bytes(self) -> Dict[str, int]:
        return {k: sum(v[k] for v in self._tally.values())
                for k in _KINDS + ("total",)}

    @property
    def collectives_by_axis(self) -> Dict[str, Dict[str, int]]:
        return self._tally

    # ------------------------------------------------------- collectives
    def _host(self) -> str:
        """Where small control tensors live: NCCL carries only CUDA
        tensors, gloo takes host ones (no device sync)."""
        return "cuda" if dist.get_backend(self.group) == "nccl" else "cpu"

    def _fingerprint(self, op: str, t: torch.Tensor, group) -> None:
        if not self.check:
            return
        f = torch.tensor([_OPS[op], _DTYPES.get(t.dtype, 0), t.numel()],
                         dtype=torch.int64, device=self._host())
        both = torch.cat([f, -f])
        dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
        hi, lo = both[:3], -both[3:]
        if not torch.equal(hi, lo):
            raise CollectiveMismatch(
                f"rank {self.rank} issued {op}({t.dtype}, {t.numel()} "
                f"elements) while another rank issued a different "
                f"collective (max {hi.tolist()} vs min {lo.tolist()} over "
                f"(op, dtype, numel)): the ranks' host decisions diverged")

    def _run(self, op: str, t: torch.Tensor, kind: str,
             axis: str) -> torch.Tensor:
        if self.axis_size(axis) == 1:
            return t
        nbytes = t.numel() * t.element_size()
        by = self._tally[axis]
        by[kind] += nbytes
        by["total"] += nbytes
        by["collectives"] += 1
        if t.is_meta:             # shape-only: no peer, nothing to move
            return t
        group, src = self._groups[axis]
        t0 = time.perf_counter()
        self._fingerprint(op, t, group)
        if op == "broadcast":
            dist.broadcast(t, src=src, group=group)
        else:
            dist.all_reduce(t, op=(dist.ReduceOp.SUM if op == "sum"
                                   else dist.ReduceOp.MAX),
                            group=group)
        by["seconds"] += time.perf_counter() - t0
        return t

    def all_reduce(self, t: torch.Tensor, op: str = "sum", *,
                   axis: str = "model") -> torch.Tensor:
        """In-place ``all_reduce`` of ``t`` (``op`` "sum" or "max") over
        ``axis``; returns ``t``. A SUM of a ``t`` that requires grad is
        out of place, with the identity backward."""
        if self.axis_size(axis) > 1 and _wants_grad(t):
            if op != "sum":
                raise NotImplementedError(
                    f"all_reduce {op!r} has no adjoint: only SUM carries "
                    f"grads")
            return _Sum.apply(self, axis, t)
        return self._run(op, t, "all-reduce", axis)

    def enter(self, t: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """``t``, whole on every rank of ``axis``, where it starts
        computing on this rank's block (the input of a column split, a
        slice of this rank's columns or channels): the identity, whose
        backward sums the ranks' partial grads of ``t`` over ``axis``.
        ``t`` itself when no grad is taken."""
        if self.axis_size(axis) == 1 or not _wants_grad(t):
            return t
        return _Enter.apply(self, axis, t)

    def count_once(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """``t``, whole on every rank of ``axis``, as a term of an
        objective whose parts are summed over ``axis``: the identity,
        whose backward passes the grad on the axis's rank 0 and zeros
        elsewhere, so the sum counts it once."""
        if self.axis_size(axis) == 1 or not _wants_grad(t):
            return t
        return _Once.apply(self.axis_rank(axis) == 0, t)

    def sum_flat(self, ts: Sequence[torch.Tensor], *,
                 axis: str = "data") -> List[torch.Tensor]:
        """Each of ``ts`` summed over ``axis``, through one ``all_reduce``
        a dtype of a flat buffer in that dtype; the results are views of
        the buffers, ``ts`` unchanged."""
        ts = list(ts)
        if self.axis_size(axis) == 1:
            return ts
        out: List[torch.Tensor] = [None] * len(ts)
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(ts):
            groups.setdefault(t.dtype, []).append(i)
        for dtype, idx in groups.items():
            buf = torch.empty(sum(ts[i].numel() for i in idx), dtype=dtype,
                              device=ts[idx[0]].device)
            views, off = [], 0
            for i in idx:
                n = ts[i].numel()
                views.append(buf[off:off + n].view(ts[i].shape))
                views[-1].copy_(ts[i].detach())
                off += n
            self._run("sum", buf, "all-reduce", axis)
            for i, v in zip(idx, views):
                out[i] = v
        return out

    def all_gather_into(self, whole: torch.Tensor, *,
                        axis: str = "data") -> torch.Tensor:
        """``whole``, zero but for the block this rank wrote (each
        position written by one rank of ``axis``: a ZeRO-1 param slice),
        made whole on every rank in place: the exact gather of
        :meth:`all_gather`, on a contiguous buffer the caller filled."""
        if self.axis_size(axis) > 1:
            self._sum_exact(whole, axis)
        return whole

    def broadcast(self, t: torch.Tensor, *,
                  axis: str = "model") -> torch.Tensor:
        """In place: every rank of ``axis`` gets the ``t`` of the rank at
        coordinate 0 on it; returns ``t``."""
        return self._run("broadcast", t, "broadcast", axis)

    def all_gather(self, t: torch.Tensor, dim: int, *,
                   axis: str = "model") -> torch.Tensor:
        """This rank's block ``t`` of a tensor split evenly along ``dim``
        over ``axis`` -> the whole tensor, exactly: a zero buffer with
        ``t`` at this rank's block, summed over the ranks."""
        return self.all_gather_many([t], dim, axis=axis)[0]

    def all_gather_many(self, ts: Sequence[torch.Tensor], dim: int, *,
                        axis: str = "model") -> List[torch.Tensor]:
        """:meth:`all_gather` of several blocks (one dtype, one shape but
        along ``dim``) through ONE collective."""
        if self.axis_size(axis) == 1:
            return list(ts)
        if _wants_grad(*ts):
            return list(_Gather.apply(self, axis, dim % ts[0].dim(), *ts))
        return self._gather_many(ts, dim, axis)

    def _gather_many(self, ts: Sequence[torch.Tensor], dim: int,
                     axis: str) -> List[torch.Tensor]:
        n, r = self.axis_size(axis), self.axis_rank(axis)
        dim = dim % ts[0].dim()
        widths = [t.shape[dim] for t in ts]
        shape = list(ts[0].shape)
        shape[dim] = n * sum(widths)
        buf = torch.zeros(shape, dtype=ts[0].dtype, device=ts[0].device)
        off = 0
        for t, w in zip(ts, widths):
            buf.narrow(dim, off + r * w, w).copy_(t)
            off += n * w
        self._sum_exact(buf, axis)
        out, off = [], 0
        for w in widths:
            out.append(buf.narrow(dim, off, n * w))
            off += n * w
        return out

    def all_gather_rows(self, t: torch.Tensor, rows: Sequence[int], n: int,
                        *, axis: str = "data") -> torch.Tensor:
        """The (n, ...) whole of which this rank holds rows ``rows`` (host
        ints; ``t`` (len(rows), ...)), each row written by exactly one
        rank of ``axis`` (a row none writes is zero): one exact gather,
        whatever the number of rows each rank holds."""
        if self.axis_size(axis) == 1:
            assert len(rows) == n, (len(rows), n)
            return t
        if _wants_grad(t):
            return _GatherRows.apply(self, axis, tuple(rows), n, t)
        return self._gather_rows(t, rows, n, axis)

    def _gather_rows(self, t: torch.Tensor, rows: Sequence[int], n: int,
                     axis: str) -> torch.Tensor:
        buf = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        if len(rows):
            buf[torch.as_tensor(list(rows), device=t.device)] = t
        return self._sum_exact(buf, axis)

    def seq_split(self, t: torch.Tensor, dim: int = 1, *,
                  axis: str = "model") -> torch.Tensor:
        """This rank's block of ``t`` (whole on every rank of ``axis``)
        along ``dim``, as a fresh contiguous tensor (never a view: a view
        would keep the whole storage alive wherever the block is saved).
        The n positions are cut in blocks of ceil(n / size), rank r's
        the r-th, its tail past n zero-padded (an uneven n leaves the last
        ranks short or empty). No collective; backward: the exact gather
        of the ranks' grad blocks, trimmed to n (the reduce-scatter's
        adjoint, whose SUM the ops that made ``t`` have done already)."""
        if self.axis_size(axis) == 1:
            return t
        dim = dim % t.dim()
        if _wants_grad(t):
            return _SeqSplit.apply(self, axis, dim, t)
        return self._seq_block(t, dim, axis)

    def seq_gather(self, t: torch.Tensor, n: int, dim: int = 1, *,
                   axis: str = "model") -> torch.Tensor:
        """The inverse of :meth:`seq_split`: this rank's (padded) block
        ``t`` -> the whole n positions along ``dim`` on every rank, through
        one exact gather (:meth:`all_gather`) trimmed to n. Backward: this
        rank's padded block of the whole grad, no collective."""
        if self.axis_size(axis) == 1:
            return t
        dim = dim % t.dim()
        if _wants_grad(t):
            return _SeqGather.apply(self, axis, dim, n, t)
        return self._seq_whole(t, n, dim, axis)

    def _seq_whole(self, t: torch.Tensor, n: int, dim: int,
                   axis: str) -> torch.Tensor:
        # trimmed into a contiguous tensor, the layout the unsplit
        # residual has, so the block's kernels are the same
        whole = self._gather_many([t], dim, axis)[0]
        return whole if whole.shape[dim] == n else \
            whole.narrow(dim, 0, n).contiguous()

    def _seq_block(self, t: torch.Tensor, dim: int,
                   axis: str) -> torch.Tensor:
        n, size = t.shape[dim], self.axis_size(axis)
        w = -(-n // size)
        lo = min(self.axis_rank(axis) * w, n)
        hi = min(lo + w, n)
        if hi - lo == w:
            return t.narrow(dim, lo, w).clone(
                memory_format=torch.contiguous_format)
        shape = list(t.shape)
        shape[dim] = w
        out = torch.zeros(shape, dtype=t.dtype, device=t.device)
        out.narrow(dim, 0, hi - lo).copy_(t.narrow(dim, lo, hi - lo))
        return out

    def _sum_exact(self, buf: torch.Tensor, axis: str) -> torch.Tensor:
        # summed as integers over the buffer's bytes: with one writer a
        # position, bit-exact for any dtype (-0.0 and NaNs included), and
        # gloo adds bf16 far slower than int32
        flat = buf.reshape(-1)
        flat = flat.view(torch.uint8) if flat.dtype == torch.bool else flat
        self._run("sum", flat.view(torch.int32 if flat.nbytes % 4 == 0
                                   else torch.uint8), "all-gather", axis)
        return buf

    def agree_float(self, x: float) -> float:
        """Rank 0's ``x`` on every rank of the world (one broadcast on the
        host)."""
        if not self.distributed:
            return x
        return float(self.broadcast(torch.tensor(
            [x], dtype=torch.float64, device=self._host()), axis="world")[0])

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` (picklable) on every rank of the world: two
        broadcasts, of its pickled length and of its bytes, on the host."""
        if not self.distributed:
            return obj
        import pickle

        group, src = self._groups["world"]
        t0 = time.perf_counter()
        dev = self._host()
        mine = self.rank == 0
        data = pickle.dumps(obj) if mine else b""
        n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
        self._fingerprint("broadcast", n, group)
        dist.broadcast(n, src=src, group=group)
        buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
               if mine else
               torch.zeros(int(n[0]), dtype=torch.uint8, device=dev))
        self._fingerprint("broadcast", buf, group)
        dist.broadcast(buf, src=src, group=group)
        self._tally["world"]["seconds"] += time.perf_counter() - t0
        return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


# ---------------------------------------------------------------- autograd


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy for an in-place collective (never a tensor
    autograd saved or handed over)."""
    return t.clone(memory_format=torch.contiguous_format)


def _grad_sum(mesh: Mesh, axis: str,
              gs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Over "data" the grads of a gathered tensor are each data rank's
    part: summed over the axis, through one collective. Over "model" they
    are whole on every rank already."""
    if axis != "data":
        return list(gs)
    flat = mesh._run("sum", torch.cat([g.reshape(-1) for g in gs]),
                     "all-reduce", axis)
    return [part.view(g.shape) for part, g in
            zip(torch.split(flat, [g.numel() for g in gs]), gs)]


class _Sum(torch.autograd.Function):
    """``all_reduce`` SUM of partial products, out of place; backward: the
    identity."""

    @staticmethod
    def forward(ctx, mesh, axis, t):
        return mesh._run("sum", _fresh(t), "all-reduce", axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _Enter(torch.autograd.Function):
    """The identity; backward: SUM over the axis."""

    @staticmethod
    def forward(ctx, mesh, axis, t):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, None, ctx.mesh._run("sum", _fresh(g), "all-reduce",
                                         ctx.axis)


class _Once(torch.autograd.Function):
    """The identity; backward: the grad where ``keep``, else zeros."""

    @staticmethod
    def forward(ctx, keep, t):
        ctx.keep = keep
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return None, (g if ctx.keep else torch.zeros_like(g))


class _Gather(torch.autograd.Function):
    """:meth:`Mesh.all_gather_many`; backward: this rank's block of each
    grad (over "data", of the grads summed over "data")."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *ts):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.widths = [t.shape[dim] for t in ts]
        outs = mesh._gather_many(ts, dim, axis)
        # separate tensors: a Function's outputs that are views of one
        # buffer may not be modified in place later
        return tuple(outs) if len(outs) == 1 else \
            tuple(o.contiguous() for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        r = ctx.mesh.axis_rank(ctx.axis)
        gs = _grad_sum(ctx.mesh, ctx.axis, gs)
        return (None, None, None) + tuple(
            g.narrow(ctx.dim, r * w, w) for g, w in zip(gs, ctx.widths))


class _GatherRows(torch.autograd.Function):
    """:meth:`Mesh.all_gather_rows`; backward: this rank's rows of the
    grad (over "data", of the grad summed over "data")."""

    @staticmethod
    def forward(ctx, mesh, axis, rows, n, t):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, rows
        return mesh._gather_rows(t, rows, n, axis)

    @staticmethod
    def backward(ctx, g):
        g, = _grad_sum(ctx.mesh, ctx.axis, [g])
        idx = torch.as_tensor(list(ctx.rows), dtype=torch.int64,
                              device=g.device)
        return None, None, None, None, g.index_select(0, idx)


class _SeqSplit(torch.autograd.Function):
    """:meth:`Mesh.seq_split`; backward: the ranks' grad blocks gathered
    whole and trimmed."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, t):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, t.shape[dim]
        return mesh._seq_block(t, dim, axis)

    @staticmethod
    def backward(ctx, g):
        whole = ctx.mesh._gather_many([g], ctx.dim, ctx.axis)[0]
        return None, None, None, whole.narrow(ctx.dim, 0, ctx.n)


class _SeqGather(torch.autograd.Function):
    """:meth:`Mesh.seq_gather`; backward: this rank's padded block of the
    grad."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, n, t):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh._seq_whole(t, n, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, None, ctx.mesh._seq_block(g, ctx.dim,
                                                           ctx.axis)


# ---------------------------------------------------------------- builders


def _world() -> Tuple[int, int]:
    """(world size, rank) of the initialized default group, (1, 0)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single pod (256 ranks) or 2×16×16 two-pod (512 ranks), over a
    world of exactly that size; raises otherwise."""
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    want = 512 if multi_pod else 256
    size, rank = _world()
    if size != want:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs a world of "
            f"{want} ranks; this one has {size}")
    return Mesh(shape, rank)


def make_local_mesh() -> Mesh:
    """(ranks, 1) ("data", "model") mesh over the initialized world (one
    rank without one): every rank holds the whole model and its block of
    the batch."""
    size, rank = _world()
    return Mesh({"data": size, "model": 1}, rank)


def make_sim_mesh(n: int) -> Mesh:
    """(1, n) ("data", "model") mesh over the ``n`` ranks of the world —
    the stand-in for an n-card edge cluster, so the sharded serving paths
    (expert-parallel stores, KV slots over "model") run for real.

    Raises a clear ``RuntimeError`` when the world has fewer than ``n``
    ranks, instead of handing back a smaller mesh whose shards would all
    degrade to replication (which would green-light tests that never
    exercised the partitioning)."""
    size, rank = _world()
    if size < n:
        raise RuntimeError(
            f"make_sim_mesh({n}) needs {n} ranks but the world has {size}. "
            f"Start {n} ranks first: repro_torch.launch.mesh.spawn(fn, {n}) "
            f"(gloo on the CPU or on one shared card), or torchrun "
            f"--nproc-per-node {n}, and call make_sim_mesh({n}) in each. "
            f"Refusing to degrade to a {size}-rank mesh: its shards would "
            f"all guard down to replication and the sharded code paths "
            f"would silently not be exercised.")
    if size > n:
        raise RuntimeError(
            f"make_sim_mesh({n}) over a world of {size} ranks: a mesh over "
            f"a subset of the world is not supported")
    return Mesh({"data": 1, "model": n}, rank)


# ------------------------------------------------------------------ spawn


def _backend(device: str, n: int) -> str:
    """gloo on the CPU and for ranks that share one card; NCCL when every
    rank has a card of its own."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def init_world(rank: int, world: int, init_method: str, device: str = "cpu",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` and return
    this rank's device (``cuda:rank`` under NCCL, else ``device``)."""
    backend = _backend(device, world)
    dev = torch.device(device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def _entry(rank: int, fn: Callable, world: int, init_method: str,
           device: str, timeout_s: float, results, args) -> None:
    # one intra-op thread a rank: n ranks' default pools (a thread a core
    # each) would oversubscribe the host's cores n times over
    torch.set_num_threads(1)
    dev = init_world(rank, world, init_method, device, timeout_s)
    try:
        out = fn(rank, dev, *args)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, device: str = "cpu",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(rank, device, *args)`` on ``n`` new ranks (the port's heir
    of the JAX package's ``ensure_sim_devices``) and return their results
    in rank order. Each rank joins a world over a ``file://`` store in a
    fresh temporary directory with the process-group timeout
    ``timeout_s``; ``fn`` and ``args`` must be picklable (a module-level
    function) and its result picklable on the host. A rank that raises
    makes this raise (the others are terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        init = "file://" + os.path.join(d, "store")
        procs = mp.start_processes(
            _entry, args=(fn, n, init, device, timeout_s, results, args),
            nprocs=n, join=False, start_method="spawn")
        # read the results while the ranks run: a rank's put blocks until
        # its pipe is read (join raises if a rank failed)
        done = False
        while not done:
            done = procs.join(timeout=0.05)
            while not results.empty():
                rank, out = results.get()
                got[rank] = out
    return [got[r] for r in range(n)]
