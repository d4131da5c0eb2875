"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2)
(torch twin of ``repro/models/layers/ssm.py``).

Prefill runs the linear recurrence ``h_t = a_t * h_{t-1} + b_t`` with a
log-depth scan over time (:func:`_assoc_scan`, the odd-even recursion of
``jax.lax.associative_scan``: about 2·log2(T) rounds of tensor ops, not T
launches), in blocks of channels (Mamba1) or heads (Mamba2) so that each
scanned (B, T, ..., N) f32 tensor stays under ``SCAN_BLOCK_BYTES``. Decode
is one recurrence update against an :class:`SSMCache`, written IN PLACE;
``live`` (B,) freezes finished rows (their state is written back
unchanged). The causal depthwise conv is a sum of shifted slices, with the
last ``conv - 1`` inputs kept in the cache, oldest first.

These architectures are attention-free, so only DyMoE's depth-aware
precision schedule applies: model.py hands the in/out projections over as
``(MixedPrecisionWeights, critical)`` pairs, which run from the packed codes
(K2 through ``quant/mixed.py``'s 1-expert lift). ``x_proj`` and
``dt_proj`` stay dense products, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import SSMCache
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.quant.mixed import mixed_precision_matmul

__all__ = ["init_mamba", "init_ssm_cache", "mamba_prefill", "mamba_decode",
           "mamba1_prefill", "mamba1_decode", "mamba2_prefill",
           "mamba2_decode", "SCAN_BLOCK_BYTES"]

# bytes of one scanned f32 tensor per block of channels / heads
SCAN_BLOCK_BYTES = 64 << 20


# ---------------------------------------------------------------- init


def init_mamba(cfg: ModelConfig, draw, lead=()) -> dict:
    """Mamba weights with the JAX package's layout and init; ``draw`` gives
    ``normal(shape, scale)`` (model dtype), ``uniform(shape, lo, hi)`` (f32)
    and ``full(shape, value, dtype)``, on ``draw.device``; ``lead`` the
    stacked leading dims."""
    dm, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    conv = cfg.ssm_conv
    f32 = torch.float32

    def dt_bias(width):
        u = draw.uniform(lead + (width,), math.log(1e-3), math.log(1e-1))
        return torch.log(torch.expm1(torch.exp(u)))

    if cfg.ssm_version == 1:
        r = cfg.dt_rank_actual
        a = torch.arange(1, n + 1, dtype=f32, device=draw.device)
        return {
            "in_proj": draw.normal(lead + (dm, 2 * di), dm ** -0.5),
            "conv_w": draw.normal(lead + (di, conv), conv ** -0.5),
            "conv_b": draw.full(lead + (di,), 0.0),
            "x_proj": draw.normal(lead + (di, r + 2 * n), di ** -0.5),
            "dt_proj": draw.normal(lead + (r, di), r ** -0.5),
            "dt_bias": dt_bias(di),
            "a_log": torch.log(a).expand(lead + (di, n)).contiguous(),
            "d_skip": draw.full(lead + (di,), 1.0, f32),
            "out_proj": draw.normal(lead + (di, dm), di ** -0.5),
        }
    h = cfg.ssm_heads
    a = torch.arange(1, h + 1, dtype=f32, device=draw.device)
    # in_proj emits [z(di), x(di), B(n), C(n), dt(h)]; conv runs over
    # the [x, B, C] channels
    return {
        "in_proj": draw.normal(lead + (dm, 2 * di + 2 * n + h), dm ** -0.5),
        "conv_w": draw.normal(lead + (di + 2 * n, conv), conv ** -0.5),
        "conv_b": draw.full(lead + (di + 2 * n,), 0.0),
        "dt_bias": dt_bias(h),
        "a_log": torch.log(a).expand(lead + (h,)).contiguous(),
        "d_skip": draw.full(lead + (h,), 1.0, f32),
        "gate_norm": {"scale": draw.full(lead + (di,), 1.0)},
        "out_proj": draw.normal(lead + (di, dm), di ** -0.5),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None, layers: Optional[int] = None) -> SSMCache:
    """Zero state; ``layers`` adds the leading stacked layer dim. The conv
    state has the model's dtype, the recurrent state is f32."""
    lead = () if layers is None else (layers,)
    if cfg.ssm_version == 1:
        conv_ch = cfg.d_inner
        state = (batch, cfg.d_inner, cfg.ssm_state)
    else:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_state
        state = (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    return SSMCache(
        conv_state=torch.zeros(lead + (batch, conv_ch, cfg.ssm_conv - 1),
                               dtype=dtype, device=device),
        ssm_state=torch.zeros(lead + state, dtype=torch.float32,
                              device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device))


# ---------------------------------------------------------------- helpers


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` where ``w`` is a dense tensor or a ``(MixedPrecisionWeights,
    critical)`` pair from model.py's depth tier, run from the packed codes
    (``skip_to_zero=False``: "x/0" on a projection would ablate the block,
    so ``low is None`` keeps high)."""
    if isinstance(w, tuple):
        mp, critical = w
        return mixed_precision_matmul(x, mp, critical, skip_to_zero=False,
                                      out_dtype=x.dtype)
    return x @ w


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x: (B, T, C); w: (C, conv) depthwise causal conv, in x's dtype."""
    conv, t = w.shape[1], x.shape[1]
    xp = F.pad(x, (0, 0, conv - 1, 0))
    y = sum(xp[:, j:j + t, :] * w[:, j] for j in range(conv))
    return y + b


def _conv_tail(x: torch.Tensor, conv: int) -> torch.Tensor:
    """The cache's conv state after a prefill of x (B, T, C): the last
    conv - 1 inputs (zeros before the first), as (B, C, conv - 1)."""
    t = x.shape[1]
    return F.pad(x, (0, 0, conv - 1, 0))[:, t:t + conv - 1].transpose(1, 2)


def _conv_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x1: (B, C); conv_state: (B, C, conv-1) of past inputs (oldest
    first). Returns (y (B, C) in x1's dtype, the next conv state)."""
    window = torch.cat([conv_state, x1[:, :, None]], dim=-1)   # (B, C, conv)
    y = torch.einsum("bcj,cj->bc", window.to(torch.float32),
                     w.to(torch.float32)) + b.to(torch.float32)
    return y.to(x1.dtype), window[:, :, 1:]


def _scan_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The ``b`` half of ``jax.lax.associative_scan`` over dim 1 with
    combine ``(ax, bx), (ay, by) -> (ax·ay, ay·bx + by)``: the same
    odd-even recursion, so the same products and sums. ``a`` may be a
    broadcast of smaller shape (Mamba2's per-head decay); the ``a`` half of
    the result is never needed, so it is not formed."""
    n = b.shape[1]
    if n < 2:
        return b
    a_odd = a[:, 1::2]
    ob = _scan_b(a[:, 0:-1:2] * a_odd, a_odd * b[:, 0:-1:2] + b[:, 1::2])
    eb = a[:, 2::2] * (ob[:, :-1] if n % 2 == 0 else ob) + b[:, 2::2]
    eb = torch.cat([b[:, :1], eb], dim=1)
    k = ob.shape[1]
    out = torch.stack([eb[:, :k], ob], dim=2).flatten(1, 2)
    return torch.cat([out, eb[:, k:]], dim=1) if eb.shape[1] > k else out


def _assoc_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor]) -> torch.Tensor:
    """Run h_t = a_t * h_{t-1} + b_t along dim 1 (time); returns every h_t.
    a, b: (B, T, ...) (``a`` broadcastable to ``b``); h0: (B, ...) the
    initial state, folded into step 0 (None: a zero state)."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return _scan_b(a, b)


def _blocks(total: int, unit_bytes: int):
    """Slices of ``total`` channels / heads, each at most
    ``SCAN_BLOCK_BYTES`` when one costs ``unit_bytes``."""
    step = max(1, min(total, SCAN_BLOCK_BYTES // max(unit_bytes, 1)))
    return [slice(i, min(i + step, total)) for i in range(0, total, step)]


def _write_state(cache: SSMCache, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, steps: int,
                 live: Optional[torch.Tensor]) -> None:
    """Write the new state into ``cache`` in place; rows with ``live``
    False keep theirs (the JAX package's freeze of finished rows)."""
    length = cache.length + steps
    if live is not None:
        lv = live.to(torch.bool)
        conv_state = torch.where(lv[:, None, None], conv_state,
                                 cache.conv_state)
        ssm_state = torch.where(
            lv.reshape((-1,) + (1,) * (ssm_state.dim() - 1)), ssm_state,
            cache.ssm_state)
        length = torch.where(lv, length, cache.length)
    cache.conv_state.copy_(conv_state)
    cache.ssm_state.copy_(ssm_state)
    cache.length.copy_(length)


# ---------------------------------------------------------------- mamba1


def _mamba1_abc(p, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (B, T, di) post-conv activations -> (dt, a, bmat, cmat)."""
    n, r = cfg.ssm_state, cfg.dt_rank_actual
    dbc = (xc @ p["x_proj"]).to(torch.float32)              # (B, T, r+2n)
    dt_low, bmat, cmat = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = _softplus(dt_low @ p["dt_proj"].to(torch.float32)
                   + p["dt_bias"])                          # (B, T, di)
    a = -torch.exp(p["a_log"])                              # (di, N)
    return dt, a, bmat, cmat


def mamba1_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[SSMCache]
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, T, dm). Writes the state after the last token into ``cache``
    (fresh, or carrying the state to continue from); ``cache`` None starts
    from a zero state and keeps none (the training forward: writing a cache
    the scan read would modify a tensor that autograd saved)."""
    bsz, t, _ = x.shape
    xin, z = _proj(x, p["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xin, p["conv_w"], p["conv_b"]))
    dt, a, bmat, cmat = _mamba1_abc(p, cfg, xc)
    xf = xc.to(torch.float32)
    dtx = dt * xf
    y = torch.empty_like(xf)
    h_last = None if cache is None else torch.empty_like(cache.ssm_state)
    for c in _blocks(cfg.d_inner, bsz * t * cfg.ssm_state * 4):
        decay = torch.exp(dt[..., c, None] * a[c])          # (B,T,c,N)
        contrib = dtx[..., c, None] * bmat[:, :, None, :]
        h = _assoc_scan(decay, contrib,
                        None if cache is None else cache.ssm_state[:, c])
        y[..., c] = torch.einsum("btdn,btn->btd", h, cmat)
        if cache is not None:
            h_last[:, c] = h[:, -1]
        del decay, contrib, h
    y = y + p["d_skip"] * xf
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = _proj(y, p["out_proj"])
    if cache is not None:
        _write_state(cache, _conv_tail(xin, cfg.ssm_conv), h_last, t, None)
    return out, cache


def mamba1_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                  live: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, SSMCache]:
    """x1: (B, 1, dm). The cache advances in place (``live`` freezes)."""
    xin, z = _proj(x1[:, 0], p["in_proj"]).chunk(2, dim=-1)  # (B, di)
    xc, conv_state = _conv_step(xin, cache.conv_state, p["conv_w"],
                                p["conv_b"])
    xc = F.silu(xc)
    dt, a, bmat, cmat = _mamba1_abc(p, cfg, xc[:, None])    # T = 1
    dt, bmat, cmat = dt[:, 0], bmat[:, 0], cmat[:, 0]
    xf = xc.to(torch.float32)
    decay = torch.exp(dt[..., None] * a)                    # (B, di, N)
    contrib = (dt * xf)[..., None] * bmat[:, None, :]
    h = decay * cache.ssm_state + contrib
    y = torch.einsum("bdn,bn->bd", h, cmat) + p["d_skip"] * xf
    y = (y * F.silu(z.to(torch.float32))).to(x1.dtype)
    out = _proj(y, p["out_proj"])[:, None]
    _write_state(cache, conv_state, h, 1, live)
    return out, cache


# ---------------------------------------------------------------- mamba2


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + n], proj[..., 2 * di + n:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def mamba2_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[SSMCache]
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """As :func:`mamba1_prefill` (``cache`` None: a zero state, none
    kept)."""
    bsz, t, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    hh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, bmat, cmat, dt_low = _mamba2_split(cfg, _proj(x, p["in_proj"]))
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)          # (B, T, di+2n)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"])
                      ).to(torch.float32)
    xc, bmat, cmat = (conv_out[..., :di], conv_out[..., di:di + n],
                      conv_out[..., di + n:])
    dt = _softplus(dt_low.to(torch.float32) + p["dt_bias"])  # (B, T, H)
    a = -torch.exp(p["a_log"])                              # (H,)
    xh = xc.reshape(bsz, t, hh, pd)
    decay = torch.exp(dt * a)[..., None, None]              # (B,T,H,1,1)
    dtx = dt[..., None] * xh                                # (B,T,H,P)
    y = torch.empty_like(xh)
    h_last = None if cache is None else torch.empty_like(cache.ssm_state)
    for c in _blocks(hh, bsz * t * pd * n * 4):
        contrib = dtx[:, :, c, :, None] * bmat[:, :, None, None, :]
        h = _assoc_scan(decay[:, :, c], contrib,
                        None if cache is None else cache.ssm_state[:, c])
        y[:, :, c] = torch.einsum("bthpn,btn->bthp", h, cmat)
        if cache is not None:
            h_last[:, c] = h[:, -1]
        del contrib, h
    y = y + p["d_skip"][:, None] * xh
    y = y.reshape(bsz, t, di)
    y = rmsnorm(p["gate_norm"],
                (y * F.silu(z.to(torch.float32))).to(x.dtype), cfg.norm_eps)
    out = _proj(y, p["out_proj"])
    if cache is not None:
        _write_state(cache, _conv_tail(conv_in, cfg.ssm_conv), h_last, t,
                     None)
    return out, cache


def mamba2_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                  live: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, SSMCache]:
    bsz = x1.shape[0]
    di, n = cfg.d_inner, cfg.ssm_state
    hh, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xin, bmat, cmat, dt_low = _mamba2_split(
        cfg, _proj(x1[:, 0], p["in_proj"]))
    conv_in = torch.cat([xin, bmat, cmat], dim=-1)          # (B, di+2n)
    conv_out, conv_state = _conv_step(conv_in, cache.conv_state,
                                      p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out.to(torch.float32))
    xc, bmat, cmat = (conv_out[..., :di], conv_out[..., di:di + n],
                      conv_out[..., di + n:])
    dt = _softplus(dt_low.to(torch.float32) + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["a_log"])
    xh = xc.reshape(bsz, hh, pd)
    decay = torch.exp(dt * a)[..., None, None]              # (B, H, 1, 1)
    contrib = (dt[..., None] * xh)[..., None] * bmat[:, None, None, :]
    h = decay * cache.ssm_state + contrib                   # (B, H, P, N)
    y = torch.einsum("bhpn,bn->bhp", h, cmat) + p["d_skip"][:, None] * xh
    y = y.reshape(bsz, di)
    y = rmsnorm(p["gate_norm"],
                (y * F.silu(z.to(torch.float32))).to(x1.dtype), cfg.norm_eps)
    out = _proj(y, p["out_proj"])[:, None]
    _write_state(cache, conv_state, h, 1, live)
    return out, cache


def mamba_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                  cache: Optional[SSMCache]):
    fn = mamba1_prefill if cfg.ssm_version == 1 else mamba2_prefill
    return fn(p, cfg, x, cache)


def mamba_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                 live: Optional[torch.Tensor] = None):
    fn = mamba1_decode if cfg.ssm_version == 1 else mamba2_decode
    return fn(p, cfg, x1, cache, live)
