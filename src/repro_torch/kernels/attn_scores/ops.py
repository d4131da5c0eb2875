"""Public entry point of attention with per-key mass (torch twin of
``repro/kernels/attn_scores/ops.py``).

Dispatch is by the device of ``q`` alone: a CUDA tensor launches K4 then K5
(or raises — there is no fallback), a CPU tensor runs their plain PyTorch
versions. Nothing else selects the implementation. A meta tensor gets
empty outputs of the plain versions' shapes and dtypes. Each of the two
kernel calls is one :class:`~repro_torch.kernels._scope.kernel_scope`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import on_cuda
from repro_torch.kernels._scope import kernel_scope
from repro_torch.kernels.attn_scores import ref
from repro_torch.kernels.attn_scores.attn_scores import flash_fwd_cuda, \
    key_mass_cuda

__all__ = ["flash_attention_with_scores"]


def flash_attention_with_scores(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-sequence attention with heavy-hitter scores.

    q, k, v: (H, S, D) head-major (GQA callers repeat KV heads first).
    Returns out (H, S, D) f32 and token_importance (S,) f32 — the per-key
    attention mass averaged over heads, DyMoE Eq. 1.
    """
    with kernel_scope("flash_fwd", q, k, v) as ks:
        if q.is_meta:
            out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
            lse = torch.empty(q.shape[:2], dtype=torch.float32,
                              device=q.device)
        elif not on_cuda(q):
            out, lse = ref.flash_fwd_ref(q, k, v, causal=causal)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_fwd_cuda(q, k, v, causal=causal)
        ks.done((out, lse))
    with kernel_scope("key_mass", q, k, lse) as ks:
        if q.is_meta:
            mass = torch.empty(q.shape[:2], dtype=torch.float32,
                               device=q.device)
        elif not on_cuda(q):
            mass = ref.key_mass_ref(q, k, lse, causal=causal)
        else:
            mass = key_mass_cuda(q, k, lse, causal=causal)
        ks.done(mass)
    return out, mass.mean(dim=0)
