"""AdamW with decoupled weight decay, and LR schedules (torch twin of
``repro/training/optimizer.py``), over trees of tensors.

Not ``torch.optim``: the reference's order of operations is kept step for
step — grads cast to f32; one global-norm clip (``+ 1e-9``); ``step + 1``;
bias corrections from the step in f32; ``u = m̂ / (sqrt(n / bc2) + eps)``;
weight decay added to ``u`` only for leaves of two or more dims; the update
in f32, cast back to the param's dtype. The schedules compute in f32
tensors, as the ``jnp`` versions do.

Under a mesh (the train step of one rank, ``models/model.py``) the
params, grads and moments may be ``Shard`` leaves, a rank's blocks: the
global-norm clip sums each leaf's squares over the "model" ranks that
split it and counts a leaf held whole on several ranks once (one
collective for every leaf); weight decay keys on the whole leaf's rank;
and a moment split over the data axes too (ZeRO-1, ``zero1_shardings``)
updates its slice of the grad and of the param, computed into its block
of the whole param, which the data ranks gather (one exact collective a
leaf). The update is elementwise, so it runs a chunk of a leaf at a time
(bounded f32 temporaries), and a slice's update is the whole's: ZeRO-1
gives the same bits as without it.

Parity traps: a Python number over a tensor, ``c / t``, is
``t.reciprocal() * c`` in torch, not a division, so a constant numerator is
made a tensor first; and ``jnp.cos`` on the CPU is glibc's ``cosf``, which
is not correctly rounded (nor is ``torch.cos``), so the cosine schedule
takes its cosine from :func:`_cosf`, glibc's algorithm in f64 tensor ops.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.sharding.partition import MODEL_AXIS, Shard, _axis_size, \
    _split_dims
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWState", "AdamW", "cosine_lr", "constant_lr"]


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


# glibc's __sincosf_table (sysdeps/ieee754/flt-32): the quadrant reduction
# constants, then the cosine and sine polynomials; the second row serves
# the quadrants whose cosine is negated
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2/pi · 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")         # pi/2
_COS = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
        float.fromhex("0x1.55553e1068f19p-5"),
        float.fromhex("-0x1.6c087e89a359dp-10"),
        float.fromhex("0x1.99343027bf8c3p-16"))
_SIN = (float.fromhex("-0x1.555545995a603p-3"),
        float.fromhex("0x1.1107605230bc4p-7"),
        float.fromhex("-0x1.994eb3774cf24p-13"))


def _top12(y: torch.Tensor) -> torch.Tensor:
    """Exponent and top 3 mantissa bits of an f32 (glibc's abstop12)."""
    return (y.view(torch.int32) >> 20) & 0x7FF


def _poly(x: torch.Tensor, x2: torch.Tensor, cos_sign: float,
          is_cos: torch.Tensor) -> torch.Tensor:
    """glibc's sinf_poly: the cosine polynomial where ``is_cos``, else the
    sine one, in the same order of f64 operations."""
    c0, c1, c2, c3, c4 = (cos_sign * c for c in _COS)
    s1, s2, s3 = _SIN
    x4 = x2 * x2
    cos = (c0 + x2 * c1) + x4 * c2 + (x4 * x2) * (c3 + x2 * c4)
    x3 = x * x2
    sin = (x + x3 * s1) + (x3 * x2) * (s2 + x2 * s3)
    return torch.where(is_cos, cos, sin)


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` of an f32 tensor, bit for bit, for |y| < 120 (the
    schedule's arguments lie in [0, pi])."""
    x = y.to(torch.float64)
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24     # quadrant
    r = x - n.to(torch.float64) * _HPI
    r = torch.where((n & 3 == 1) | (n & 3 == 2), -r, r)
    odd = (n & 1) == 0                        # cos(r) in quadrants 0 and 2
    reduced = torch.where((n & 2) != 0, _poly(r, r * r, -1.0, odd),
                          _poly(r, r * r, 1.0, odd))
    top = _top12(y)
    near = _poly(x, x * x, 1.0, torch.ones_like(odd))
    out = torch.where(top < _top12(torch.tensor(math.pi / 4,
                                                 dtype=torch.float32)),
                      near, reduced)
    out = torch.where(top < _top12(torch.tensor(2.0 ** -12,
                                                dtype=torch.float32)),
                      torch.ones_like(out), out)
    return out.to(torch.float32)


def cosine_lr(peak: float, warmup: int, total: int, floor: float = 0.1
              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor · peak`` at ``total``; f32, from an integer step tensor."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak * torch.clamp(step / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak * (floor + (1 - floor) * 0.5
                      * (1 + _cosf(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return sched


def constant_lr(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0

    def init(self, params, specs=None, mesh=None) -> AdamWState:
        """Zero f32 moments shaped as ``params``; the step on the device of
        the first leaf. A ``Shard`` param gets a ``Shard`` moment of its
        block. ``specs`` (a spec tree of the params' structure, e.g.
        ``zero1_shardings`` of them) and ``mesh``: each moment is this
        rank's block under its spec instead, a ``Shard`` wherever the
        spec splits it over an axis above 1."""
        dev = tree_leaves(params)[0].device

        def zeros(p, spec=None):
            if spec is None:
                if isinstance(p, Shard):
                    return Shard(torch.zeros_like(p.local,
                                                  dtype=torch.float32),
                                 p.splits, p.mesh)
                return torch.zeros_like(p, dtype=torch.float32)
            splits = _split_dims(spec, mesh)
            shape = list(p.shape)
            for d, axes in splits.items():
                shape[d] //= _axis_size(mesh, axes)
            t = torch.zeros(shape, dtype=torch.float32, device=p.device)
            return Shard(t, splits, mesh) if splits else t

        def moments():
            if specs is None:
                return tree_map(zeros, params)
            return tree_map(zeros, params, specs)

        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=moments(), nu=moments())

    def update(self, params, grads, state: AdamWState):
        """Returns (new params, new state); nothing given is modified. The
        leaves are updated one at a time, a chunk at a time, so no f32
        copy of every grad is held at once. ``Shard`` leaves are one
        rank's blocks (module docstring); without them no collective
        runs."""
        mesh = next((x.mesh for tree in (params, state.mu)
                     for x in tree_leaves(tree) if isinstance(x, Shard)),
                    None)
        scale = None
        if self.grad_clip:
            # each leaf's sum of squares, a whole leaf's on model rank 0
            # only, summed over "model" in ONE collective; then over the
            # leaves in leaf order, as the one-device sum
            sq = torch.stack([
                torch.sum(torch.square(_local(g).to(torch.float32)))
                if mesh is None or isinstance(g, Shard)
                or mesh.model_rank == 0
                else torch.zeros((), dtype=torch.float32,
                                 device=_local(g).device)
                for g in tree_leaves(grads)])
            if mesh is not None:
                sq = mesh.all_reduce(sq, axis=MODEL_AXIS)
            gnorm = torch.sqrt(sum(sq.unbind()))
            clip = torch.full_like(gnorm, self.grad_clip)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        lr = self.lr(step)
        out = []
        decay = self.weight_decay

        def upd(p, g, m, n):
            pl, g, ml, nl = _local(p), _local(g), _local(m), _local(n)
            dd = _data_dim(m)
            if dd is None:
                whole = new = torch.empty_like(pl)
            else:
                # ZeRO-1: this rank's slice, computed into its block of the
                # whole param, which the data ranks then gather
                lo, w = m.mesh.data_rank * ml.shape[dd], ml.shape[dd]
                whole = torch.zeros_like(pl)
                new = whole.narrow(dd, lo, w)
                pl, g = pl.narrow(dd, lo, w), g.narrow(dd, lo, w)
            m1, n1 = torch.empty_like(ml), torch.empty_like(nl)
            # elementwise, so a chunk at a time gives the same bits and
            # holds a chunk's f32 temporaries, not a leaf's
            for r in _chunks(tuple(pl.shape)):
                gr = g[r].to(torch.float32)
                if scale is not None:
                    gr = gr * scale
                mr = b1 * ml[r] + (1 - b1) * gr
                nr = b2 * nl[r] + (1 - b2) * gr * gr
                u = (mr / bc1) / (torch.sqrt(nr / bc2) + self.eps)
                if decay and len(p.shape) >= 2:
                    u = u + decay * pl[r].to(torch.float32)
                new[r] = (pl[r].to(torch.float32) - lr * u).to(pl.dtype)
                m1[r], n1[r] = mr, nr
            if dd is not None:
                m.mesh.all_gather_into(whole, axis="data")
            out.append((whole, _like(m, m1), _like(n, n1)))

        tree_map(upd, params, grads, state.mu, state.nu)
        it = iter(out)
        new_p = tree_map(lambda p: _like(p, next(it)[0]), params)
        return new_p, AdamWState(
            step=step, mu=tree_unflatten(params, [o[1] for o in out]),
            nu=tree_unflatten(params, [o[2] for o in out]))


def _local(x):
    return x.local if isinstance(x, Shard) else x


# elements of one chunk of the update
_CHUNK = 1 << 24


def _chunks(shape: Tuple[int, ...]) -> list:
    """Index tuples tiling a tensor of ``shape``, each a view of at most
    ``_CHUNK`` elements where the last indexed dim allows (ints over the
    leading dims, then a slice of rows)."""
    if not shape:
        return [()]
    k = 0
    while k + 1 < len(shape) and math.prod(shape[k + 1:]) > _CHUNK:
        k += 1
    rows = max(1, _CHUNK // max(1, math.prod(shape[k + 1:])))
    return [head + (slice(i, i + rows),)
            for head in itertools.product(*map(range, shape[:k]))
            for i in range(0, shape[k], rows)]


def _like(x, t: torch.Tensor):
    """``t`` as the block of a leaf laid out as ``x``."""
    return Shard(t, x.splits, x.mesh) if isinstance(x, Shard) else t


def _data_dim(m):
    """The dim of the moment ``m`` split over the data axes alone (ZeRO-1),
    None if none is."""
    if isinstance(m, Shard):
        for d, axes in m.splits.items():
            if MODEL_AXIS not in axes:
                return d
    return None
