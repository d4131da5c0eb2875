"""Grouped-query attention with RoPE and qk-norm (torch twin of
``repro/models/layers/attention.py``; plain torch — the projections and
attention einsums are the large matmuls the JAX package leaves to XLA).

  * ``attention_train`` — full-sequence causal attention for prefill,
    q-chunked so the S×S probability matrix is never whole; optionally
    returns the per-token received-attention mass of Eq. 1.
  * ``attention_decode`` — one-token step against a :class:`KVCache`.

GQA runs in grouped layout (B, H_kv, G, S, D), so KV heads are never
replicated. Shapes are batch-major: x (B, S, d_model).

Under a mesh (``sharding/spmd.py``) the projections may be split: q, k and
v come back whole on every rank through one gather, ``wo`` is a row split
ended by a SUM. Prefill attention then runs whole on every rank (its Eq. 1
mass is the one-device value); a decode step against a cache whose slots
are split over the ranks is flash-decode: each rank's (max, sum, weighted
V) over its own slots, gathered in one collective and combined (the MAX
of the maxima, then the rescaled SUMs).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import KVCache, update_kv_cache
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rotary import apply_rope
from repro_torch.sharding import spmd

__all__ = ["attention_train", "attention_decode"]

_NEG_INF = -1e30


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.attn_compute_dtype)


def _project_qkv(p, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor):
    """x: (B, S, dm) -> q (B,Hkv,G,S,D), k/v (B,Hkv,S,D), RoPE applied."""
    b, s, _ = x.shape
    h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = spmd.project_many(
        x, [p["wq"], p["wk"], p["wv"]],
        [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else None)
    q = q.reshape(b, s, h, d).transpose(1, 2)            # (B, H, S, D)
    k = k.reshape(b, s, hk, d).transpose(1, 2)           # (B, Hkv, S, D)
    v = v.reshape(b, s, hk, d).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q.reshape(b, hk, cfg.kv_groups, s, d), k, v


def _pick_chunk(s: int, target: int = 1024) -> int:
    """Largest divisor of s that is <= target."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def attention_train(p, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    want_token_importance: bool = False,
                    chunk: int = 1024
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention, q-chunked. ``kv_valid`` (B, S) masks keys
    per row (False marks left padding of a right-aligned ragged batch):
    no query attends to a pad and pads gather no received mass. Returns
    (out (B,S,dm), token_importance (B,S) or None, (k, v))."""
    b, s, _ = x.shape
    dev = x.device
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None].expand(b, s)
    q, k, v = _project_qkv(p, cfg, x, positions)
    hk, g, d = q.shape[1], q.shape[2], q.shape[4]
    scale = d ** -0.5
    cq = _pick_chunk(s, chunk)
    cdt = _cdt(cfg)
    kf, vf = k.to(cdt), v.to(cdt)
    mass = (torch.zeros((b, hk, s), dtype=torch.float32, device=dev)
            if want_token_importance else None)
    outs = []
    for ci in range(s // cq):
        qc = q[:, :, :, ci * cq:(ci + 1) * cq].to(cdt)
        lo, hi = 0, s
        if cfg.attn_causal_skip:
            hi = (ci + 1) * cq
            if cfg.sliding_window:
                lo = max(0, ci * cq - cfg.sliding_window + 1)
        logits = torch.einsum("bkgqd,bkpd->bkgqp", qc,
                              kf[:, :, lo:hi]).to(torch.float32) * scale
        qi = ci * cq + torch.arange(cq, dtype=torch.int32, device=dev)
        kj = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        m = qi[:, None] >= kj[None, :]
        if cfg.sliding_window:
            m = m & (qi[:, None] - kj[None, :] < cfg.sliding_window)
        m = m[None, None, None]                    # (1, 1, 1, cq, hi-lo)
        if kv_valid is not None:
            m = m & kv_valid[:, None, None, None, lo:hi]
        logits = torch.where(m, logits, torch.full_like(logits, _NEG_INF))
        probs = torch.softmax(logits, dim=-1)
        oc = torch.einsum("bkgqp,bkpd->bkgqd", probs.to(cdt), vf[:, :, lo:hi])
        outs.append(oc.to(torch.float32))
        if mass is not None:
            mass[:, :, lo:hi] += probs.sum(dim=(2, 3)) / (hk * g)
    out = torch.cat(outs, dim=3).reshape(b, hk * g, s, d)
    out = out.transpose(1, 2).reshape(b, s, -1).to(x.dtype)
    out = spmd.matmul(out, p["wo"])
    token_importance = mass.sum(dim=1) if want_token_importance else None
    return out, token_importance, (k, v)


def attention_decode(p, cfg: ModelConfig, x: torch.Tensor, cache: KVCache,
                     live: Optional[torch.Tensor] = None, mesh=None
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode, x: (B, 1, dm). The cache is written in place;
    ``live`` (B,) freezes finished rows' writes. A cache whose slots are
    split over ``mesh``'s ranks is combined flash-decode style."""
    b = x.shape[0]
    positions = cache.length[:, None]    # (B, 1) position of the new token
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    cache = update_kv_cache(cache, k_new, v_new, live=live)
    cdt = _cdt(cfg)
    scale = cfg.head_dim ** -0.5
    logits = torch.einsum("bkgqd,bkpd->bkgqp", q.to(cdt),
                          cache.k.to(cdt)).to(torch.float32) * scale
    # valid slots: filled (pos >= 0) and causal (pos <= current position)
    cur = cache.length[:, None] - 1
    valid = (cache.positions >= 0) & (cache.positions <= cur)
    if cfg.sliding_window:
        valid &= cache.positions > (cur - cfg.sliding_window)
    logits = torch.where(valid[:, None, None, None, :], logits,
                         torch.full_like(logits, _NEG_INF))
    if cache.shards > 1:
        out = _split_softmax_v(mesh, logits, cache.v.to(cdt), cdt)
    else:
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqp,bkpd->bkgqd", probs.to(cdt),
                           cache.v.to(cdt)).to(torch.float32)
    out = out.reshape(b, cfg.num_heads, 1, cfg.head_dim)
    out = out.transpose(1, 2).reshape(b, 1, -1).to(x.dtype)
    return spmd.matmul(out, p["wo"]), cache


def _split_softmax_v(mesh, logits: torch.Tensor, v: torch.Tensor,
                     cdt) -> torch.Tensor:
    """softmax(logits) @ v over slots split across ``mesh``'s ranks,
    flash-decode style: each rank's (max, exp-sum, exp-weighted V) over
    its own slots, gathered exactly through ONE collective and combined
    alike on every rank (the rank maxima's MAX, then the rescaled SUMs).
    Returns f32 (B, Hkv, G, 1, D)."""
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    pv = torch.einsum("bkgqp,bkpd->bkgqd", e.to(cdt), v).to(torch.float32)
    parts = mesh.all_gather(torch.cat(
        [pv, e.sum(dim=-1, keepdim=True), m], dim=-1)[None], 0)
    # a rank with no valid slot has m = -1e30: its weight below is 0
    w = torch.exp(parts[..., -1:] - parts[..., -1:].amax(dim=0))
    return (parts[..., :-2] * w).sum(dim=0) / (parts[..., -2:-1] * w).sum(
        dim=0)
