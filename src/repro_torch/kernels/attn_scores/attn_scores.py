"""Launch wrappers of the hand-written Hopper kernels for attention with
per-key mass, beside their plain PyTorch versions.

* K4 ``flash_fwd_cuda`` (``csrc/flash_fwd.cu``) replaces
  ``flash_fwd_pallas`` (``repro/kernels/attn_scores/attn_scores.py``); its
  plain version is :func:`~repro_torch.kernels.attn_scores.ref.flash_fwd_ref`.
* K5 ``key_mass_cuda`` (``csrc/key_mass.cu``) replaces
  ``key_mass_pallas``; its plain version is
  :func:`~repro_torch.kernels.attn_scores.ref.key_mass_ref`.

Inputs are (H, S, D) head-major, f32 or bf16 (on the bf16 tensor cores,
f32 as exact bf16 planes: ``csrc/score_tile.cuh``), any S, 1 <= D <= 256;
the scale is 1/sqrt(D). Each wrapper checks
device, dtype, shape and contiguity, allocates its f32 outputs with
``torch.empty`` (the kernels write every element), launches on the
current stream without synchronising, raises if the launch is refused, and
adds one to ``LAUNCHES[name]`` per launch and nowhere else.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import load, raise_on_error
from repro_torch.kernels.attn_scores import ref

__all__ = ["flash_fwd_cuda", "key_mass_cuda", "LAUNCHES",
           "reset_launch_counts", "PLAIN"]

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "key_mass": 0}

# each kernel's plain PyTorch version (what a CPU tensor runs)
PLAIN = {"flash_fwd": ref.flash_fwd_ref, "key_mass": ref.key_mass_ref}

_MAX_HEAD_DIM = 256          # csrc/score_tile.cuh MAX_D
_BF16 = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_heads(name: str, *ts: torch.Tensor) -> Tuple[int, int, int]:
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor")
    if q.dtype not in _BF16:
        raise ValueError(f"{name}: q/k/v dtype must be float32 or bfloat16")
    if q.dim() != 3 or not 1 <= q.shape[2] <= _MAX_HEAD_DIM:
        raise ValueError(f"{name}: q/k/v must be (H, S, D) with "
                         f"1 <= D <= {_MAX_HEAD_DIM}, got {tuple(q.shape)}")
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v must be contiguous tensors of "
                             "one shape, dtype and device")
    return tuple(q.shape)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: returns out (H, S, D) f32 and lse (H, S) f32."""
    name = "flash_fwd"
    h, s, d = _check_heads(name, q, k, v)
    out = torch.empty((h, s, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = load("attn_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _BF16[q.dtype],
        out.data_ptr(), lse.data_ptr(), h, s, d, int(causal),
        1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(name, err)
    LAUNCHES[name] += 1
    return out, lse


def key_mass_cuda(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """K5: mass (H, S) f32, ``mass_j = sum_i exp(s_ij - lse_i)``."""
    name = "key_mass"
    h, s, d = _check_heads(name, q, k)
    if lse.dtype != torch.float32 or lse.shape != (h, s) or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous float32 {(h, s)} "
                         f"on {q.device}")
    mass = torch.empty((h, s), dtype=torch.float32, device=q.device)
    if mass.numel() == 0:
        return mass
    err = load("attn_key_mass")(
        q.data_ptr(), k.data_ptr(), _BF16[q.dtype], lse.data_ptr(),
        mass.data_ptr(), h, s, d, int(causal), 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(name, err)
    LAUNCHES[name] += 1
    return mass
