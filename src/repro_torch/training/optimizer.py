"""AdamW with decoupled weight decay, and LR schedules (torch twin of
``repro/training/optimizer.py``), over trees of tensors.

Not ``torch.optim``: the reference's order of operations is kept step for
step — grads cast to f32; one global-norm clip (``+ 1e-9``); ``step + 1``;
bias corrections from the step in f32; ``u = m̂ / (sqrt(n / bc2) + eps)``;
weight decay added to ``u`` only for leaves of two or more dims; the update
in f32, cast back to the param's dtype. The schedules compute in f32
tensors, as the ``jnp`` versions do.

Parity traps: a Python number over a tensor, ``c / t``, is
``t.reciprocal() * c`` in torch, not a division, so a constant numerator is
made a tensor first; and ``jnp.cos`` on the CPU is glibc's ``cosf``, which
is not correctly rounded (nor is ``torch.cos``), so the cosine schedule
takes its cosine from :func:`_cosf`, glibc's algorithm in f64 tensor ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

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

    def init(self, params) -> AdamWState:
        """Zero f32 moments shaped as ``params``; the step on the device of
        the first leaf."""
        dev = tree_leaves(params)[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params),
            nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params))

    def update(self, params, grads, state: AdamWState):
        """Returns (new params, new state); nothing given is modified. The
        leaves are updated one at a time, so no f32 copy of every grad is
        held at once."""
        scale = None
        if self.grad_clip:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(
                g.to(torch.float32))) for g in tree_leaves(grads)))
            clip = torch.full_like(gnorm, self.grad_clip)
            scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        lr = self.lr(step)
        out = []

        def upd(p, g, m, n):
            g = g.to(torch.float32)
            if scale is not None:
                g = g * scale
            m = b1 * m + (1 - b1) * g
            n = b2 * n + (1 - b2) * g * g
            u = (m / bc1) / (torch.sqrt(n / bc2) + self.eps)
            if self.weight_decay and p.dim() >= 2:
                u = u + self.weight_decay * p.to(torch.float32)
            out.append(((p.to(torch.float32) - lr * u).to(p.dtype), m, n))

        tree_map(upd, params, grads, state.mu, state.nu)
        new_p, mu, nu = zip(*out)
        return tree_unflatten(params, new_p), AdamWState(
            step=step, mu=tree_unflatten(params, mu),
            nu=tree_unflatten(params, nu))
