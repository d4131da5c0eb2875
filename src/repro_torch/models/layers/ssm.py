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

Under a ``mesh`` whose "model" axis is above 1 a rank holds the blocks
``sharding/partition.py``'s rules give it — the in-projection's columns,
the conv's channels, the out-projection's rows (a quantized store: its N
rows), the per-channel or per-head vectors, and (``init_ssm_cache``,
``cache_shardings``) its channel block of the conv state and its channel
(Mamba1) or head (Mamba2) block of the recurrent state, each whole where
"model" does not divide it. These blocks do not line up with the math,
so collectives over "model" bridge them, as GSPMD's do in the JAX
package: the in-projection is gathered whole; the conv runs on the rank's
channels; Mamba2 gathers the conv output (its heads need their x channels
and all of B and C); Mamba1's row-split ``x_proj`` is a partial product
and ONE SUM; the scan runs over the rank's channels or heads; Mamba2's
gate norm, before an out-projection that reads its input whole (a
quantized store split along d_model), gathers the gated block and the
norm's scale in ONE collective and runs as on one device, or, before a
row-split float out-projection, SUMs its sums of squares; the
out-projection is then a row split ended by a SUM, or a local product
whose output is gathered. Which block a rank holds is read from its
``Shard`` weights (its cache's blocks are those of ``conv_w`` and
``d_skip``), never inferred from sizes. With nothing split, every block
is the whole and no collective runs: the one-device program.

Under grads (the train step, ``cache`` None) a tensor whole on every rank
passes through ``Mesh.enter`` where a rank narrows it to its block (its
conv channels, scanned channels or heads, a weight it holds whole), and
the SUMs and gathers carry their adjoints (``launch/mesh.py``): so the
grad of every tensor whole on the "model" ranks is whole there too.
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
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import Shard, model_split

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
                   device=None, layers: Optional[int] = None,
                   mesh=None) -> SSMCache:
    """Zero state; ``layers`` adds the leading stacked layer dim. The conv
    state has the model's dtype, the recurrent state is f32. Under
    ``mesh`` a rank allocates only its block of the conv channels and of
    the state's channels (Mamba1) or heads (Mamba2) where "model" divides
    them (``cache_shardings``' layout: the blocks of the layer's
    ``conv_w`` and ``d_skip``); ``batch`` is its rows."""
    lead = () if layers is None else (layers,)
    conv = cfg.d_inner + (2 * cfg.ssm_state if cfg.ssm_version == 2 else 0)
    units = cfg.d_inner if cfg.ssm_version == 1 else cfg.ssm_heads
    conv_held = conv // model_split(mesh, conv)["shards"]
    units_held = units // model_split(mesh, units)["shards"]
    per_unit = (cfg.ssm_state,) if cfg.ssm_version == 1 \
        else (cfg.ssm_head_dim, cfg.ssm_state)
    return SSMCache(
        conv_state=torch.zeros(lead + (batch, conv_held, cfg.ssm_conv - 1),
                               dtype=dtype, device=device),
        ssm_state=torch.zeros(lead + (batch, units_held) + per_unit,
                              dtype=torch.float32, device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device))


# ---------------------------------------------------------------- helpers


def _packed(x: torch.Tensor, w) -> torch.Tensor:
    """``x @`` this rank's block of a ``(MixedPrecisionWeights, critical)``
    pair from model.py's depth tier, run from the packed codes
    (``skip_to_zero=False``: "x/0" on a projection would ablate the block,
    so ``low is None`` keeps high), whole on every rank: a store split
    along N gathers its local product."""
    mp, critical = w
    y = mixed_precision_matmul(x, spmd.local_mp(mp), critical,
                               skip_to_zero=False, out_dtype=x.dtype)
    return spmd.mp_mesh(mp).all_gather(y, -1) if spmd.mp_split(mp) == "n" \
        else y


def _proj_in(x: torch.Tensor, w) -> torch.Tensor:
    """The in-projection ``x @ w``, whole on every rank: ``w`` a dense
    tensor (whole, or split over its columns) or a quantized pair."""
    return _packed(x, w) if isinstance(w, tuple) else spmd.matmul(x, w)


def _proj_rows(h: torch.Tensor, hb: Tuple[int, int], w,
               mesh) -> torch.Tensor:
    """``h @ w``, whole on every rank, where ``h`` holds block ``hb`` of
    ``w``'s reduction dim: a float row split takes this rank's block of
    ``h`` and ends with ONE SUM; a whole float weight or a quantized store
    (split along N, or whole) reads ``h`` whole."""
    if isinstance(w, tuple):
        k = w[0].high.k
        return _packed(_take(h, hb, (0, k), mesh), w)
    if spmd.rows_split(w):
        return w.mesh.all_reduce(_take(h, hb, w.block(), mesh) @ w.local,
                                 "sum")
    return _take(h, hb, (0, w.shape[-2]), mesh) @ w


def _held(w, dim: int, total: int) -> Tuple[int, int]:
    """[lo, hi) of the ``total``-wide dim ``dim`` of a weight that this
    rank holds: its :class:`Shard`'s "model" block along that dim, else
    the whole."""
    if isinstance(w, Shard) and w.dim is not None \
            and w.dim == dim % w.local.dim():
        return w.block()
    return 0, total


def _take(t: torch.Tensor, have: Tuple[int, int], want: Tuple[int, int],
          mesh, dim: int = -1) -> torch.Tensor:
    """Block ``want`` of a dim of which ``t`` holds block ``have`` (this
    rank's "model" block, or the whole): a view when it holds it, else
    the exact gather of the blocks over "model" first. A whole ``t``
    narrowed to a block enters the rank's block (``Mesh.enter``)."""
    if want == have:
        return t
    if not (have[0] <= want[0] and want[1] <= have[1]):
        t = mesh.all_gather(t, dim)
        have = (0, t.shape[dim])
    if have == (0, t.shape[dim]) and want != have:
        t = mesh.enter(t)
    return t.narrow(dim, want[0] - have[0], want[1] - want[0])


def _w(w, want: Tuple[int, int], total: int, mesh,
       dim: int = 0) -> torch.Tensor:
    """Block ``want`` of dim ``dim`` of a per-channel or per-head weight
    that is whole or this rank's :class:`Shard`."""
    return _take(spmd.local(w), _held(w, dim, total), want, mesh, dim)


def _whole(mesh, total: int, *parts) -> list:
    """Each ``(t, have)`` — ``t`` holding block ``have`` of a last dim of
    ``total``, or the whole — whole on every rank: the split ones
    gathered over "model" through ONE collective (flattened, so their
    leading dims may differ)."""
    split = [t for t, have in parts if have != (0, total)]
    if not split:
        return [t for t, _ in parts]
    assert len({t.dtype for t in split}) == 1, [t.dtype for t in split]
    n = mesh.model_size
    flat = iter(mesh.all_gather_many([t.reshape(-1) for t in split], 0))
    out = []
    for t, have in parts:
        if have != (0, total):
            t = next(flat).reshape((n,) + tuple(t.shape)).movedim(0, -2) \
                .reshape(t.shape[:-1] + (n * t.shape[-1],))
        out.append(t)
    return out


def _scan_block(cfg: ModelConfig, cache: Optional[SSMCache],
                p) -> Tuple[int, int]:
    """The channels (Mamba1) or heads (Mamba2) this rank scans:
    ``d_skip``'s block, which its recurrent state's is."""
    total = cfg.d_inner if cfg.ssm_version == 1 else cfg.ssm_heads
    sb = _held(p["d_skip"], 0, total)
    assert cache is None or cache.ssm_state.shape[1] == sb[1] - sb[0], \
        (tuple(cache.ssm_state.shape), sb)
    return sb


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


def _mamba1_abc(p, cfg: ModelConfig, xc: torch.Tensor, cb, sb, mesh):
    """xc: (B, T, ·) post-conv activations over the channels ``cb`` ->
    (dt, a, bmat, cmat); dt and a over the scanned channels ``sb``."""
    n, r, di = cfg.ssm_state, cfg.dt_rank_actual, cfg.d_inner
    dbc = _proj_rows(xc, cb, p["x_proj"], mesh).to(torch.float32)
    if sb != (0, di):       # whole; dt, B and C feed this rank's channels
        dbc = mesh.enter(dbc)
    dt_low, bmat, cmat = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = _softplus(dt_low @ _w(p["dt_proj"], sb, di, mesh, 1)
                   .to(torch.float32)
                   + _w(p["dt_bias"], sb, di, mesh))        # (B, T, ·)
    a = -torch.exp(_w(p["a_log"], sb, di, mesh))            # (·, N)
    return dt, a, bmat, cmat


def _conv_block(p, total: int,
                cache: Optional[SSMCache]) -> Tuple[int, int]:
    """The conv channels this rank holds (``conv_w``'s block, which its
    conv state's is)."""
    cb = _held(p["conv_w"], 0, total)
    assert cache is None or cache.conv_state.shape[1] == cb[1] - cb[0], \
        (tuple(cache.conv_state.shape), cb)
    return cb


def mamba1_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[SSMCache], mesh=None
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """x: (B, T, dm). Writes the state after the last token into ``cache``
    (fresh, or carrying the state to continue from); ``cache`` None starts
    from a zero state and keeps none (the training forward: writing a cache
    the scan read would modify a tensor that autograd saved). ``mesh``:
    run as one rank of it (module docstring)."""
    bsz, t, _ = x.shape
    di = cfg.d_inner
    xin, z = _proj_in(x, p["in_proj"]).chunk(2, dim=-1)
    cb, sb = _conv_block(p, di, cache), _scan_block(cfg, cache, p)
    xin = _take(xin, (0, di), cb, mesh)
    xc = F.silu(_causal_conv(xin, spmd.local(p["conv_w"]),
                             spmd.local(p["conv_b"])))
    dt, a, bmat, cmat = _mamba1_abc(p, cfg, xc, cb, sb, mesh)
    xf = _take(xc, cb, sb, mesh).to(torch.float32)
    dtx = dt * xf
    y = torch.empty_like(xf)
    h_last = None if cache is None else torch.empty_like(cache.ssm_state)
    for c in _blocks(sb[1] - sb[0], bsz * t * cfg.ssm_state * 4):
        decay = torch.exp(dt[..., c, None] * a[c])          # (B,T,c,N)
        contrib = dtx[..., c, None] * bmat[:, :, None, :]
        h = _assoc_scan(decay, contrib,
                        None if cache is None else cache.ssm_state[:, c])
        y[..., c] = torch.einsum("btdn,btn->btd", h, cmat)
        if cache is not None:
            h_last[:, c] = h[:, -1]
        del decay, contrib, h
    y = y + _w(p["d_skip"], sb, di, mesh) * xf
    y = (y * F.silu(_take(z, (0, di), sb, mesh).to(torch.float32))
         ).to(x.dtype)
    out = _proj_rows(y, sb, p["out_proj"], mesh)
    if cache is not None:
        _write_state(cache, _conv_tail(xin, cfg.ssm_conv), h_last, t, None)
    return out, cache


def mamba1_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                  live: Optional[torch.Tensor] = None, mesh=None
                  ) -> Tuple[torch.Tensor, SSMCache]:
    """x1: (B, 1, dm). The cache advances in place (``live`` freezes)."""
    di = cfg.d_inner
    xin, z = _proj_in(x1[:, 0], p["in_proj"]).chunk(2, dim=-1)  # (B, di)
    cb, sb = _conv_block(p, di, cache), _scan_block(cfg, cache, p)
    xc, conv_state = _conv_step(_take(xin, (0, di), cb, mesh),
                                cache.conv_state, spmd.local(p["conv_w"]),
                                spmd.local(p["conv_b"]))
    xc = F.silu(xc)
    dt, a, bmat, cmat = _mamba1_abc(p, cfg, xc[:, None], cb, sb,
                                    mesh)                   # T = 1
    dt, bmat, cmat = dt[:, 0], bmat[:, 0], cmat[:, 0]
    xf = _take(xc, cb, sb, mesh).to(torch.float32)
    decay = torch.exp(dt[..., None] * a)                    # (B, ·, N)
    contrib = (dt * xf)[..., None] * bmat[:, None, :]
    h = decay * cache.ssm_state + contrib
    y = torch.einsum("bdn,bn->bd", h, cmat) \
        + _w(p["d_skip"], sb, di, mesh) * xf
    y = (y * F.silu(_take(z, (0, di), sb, mesh).to(torch.float32))
         ).to(x1.dtype)
    out = _proj_rows(y, sb, p["out_proj"], mesh)[:, None]
    _write_state(cache, conv_state, h, 1, live)
    return out, cache


# ---------------------------------------------------------------- mamba2


def _mamba2_split(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di],
            proj[..., 2 * di:2 * di + n], proj[..., 2 * di + n:2 * di + 2 * n],
            proj[..., 2 * di + 2 * n:])


def _mamba2_heads(cfg: ModelConfig, p, proj: torch.Tensor, conv,
                  cache: Optional[SSMCache], mesh):
    """The in-projection ``proj`` (whole) through the causal conv, ``conv``
    (its input, this rank's channel block -> (f32 activated output, next
    conv state)),
    to what the rank's heads read: (z, conv_state, xh, bmat, cmat, dt, a,
    d_skip, head block). The conv output is gathered whole over "model"
    when the conv is split: a head needs its x channels and all of B and
    C."""
    di, n, hh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    pd = cfg.ssm_head_dim
    z, xin, bmat, cmat, dt_low = _mamba2_split(cfg, proj)
    cw = di + 2 * n
    cb = _conv_block(p, cw, cache)
    conv_out, conv_state = conv(_take(torch.cat([xin, bmat, cmat], dim=-1),
                                      (0, cw), cb, mesh))
    conv_out = _take(conv_out, cb, (0, cw), mesh)
    hb = _scan_block(cfg, cache, p)
    bc = conv_out[..., di:]
    if hb != (0, hh):       # whole; B and C feed this rank's heads
        bc = mesh.enter(bc)
    xc, bmat, cmat = conv_out[..., :di], bc[..., :n], bc[..., n:]
    dt = _softplus(_take(dt_low, (0, hh), hb, mesh).to(torch.float32)
                   + _w(p["dt_bias"], hb, hh, mesh))        # (..., h)
    a = -torch.exp(_w(p["a_log"], hb, hh, mesh))            # (h,)
    xh = _take(xc, (0, di), (hb[0] * pd, hb[1] * pd), mesh)
    xh = xh.reshape(xh.shape[:-1] + (hb[1] - hb[0], pd))
    return (z, conv_state, xh, bmat, cmat, dt, a,
            _w(p["d_skip"], hb, hh, mesh), hb)


def _gate_out(p, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
              hb, dtype, mesh) -> torch.Tensor:
    """``out_proj(gate_norm(y · silu(z)))`` for ``y`` (..., h·P) over the
    heads ``hb``. The norm is an RMS over the whole d_inner. Before an
    ``out_proj`` that reads its input whole (a quantized store, split
    along N or whole, or a whole float weight) the gated block and the
    norm's scale are gathered whole in ONE collective and the norm runs
    as on one device; before a row-split float ``out_proj`` it takes ONE
    SUM of the sums of squares, then normalizes this rank's rows in
    ``rmsnorm``'s order."""
    di = cfg.d_inner
    gb = (hb[0] * cfg.ssm_head_dim, hb[1] * cfg.ssm_head_dim)
    g = (y * F.silu(_take(z, (0, di), gb, mesh).to(torch.float32))
         ).to(dtype)
    scale, out = p["gate_norm"]["scale"], p["out_proj"]
    if not spmd.rows_split(out):
        g, s = _whole(mesh, di, (g, gb),
                      (spmd.local(scale), _held(scale, 0, di)))
        return _proj_rows(rmsnorm({"scale": s}, g, cfg.norm_eps), (0, di),
                          out, mesh)
    x = g.to(torch.float32)
    if gb == (0, di):
        var = (x * x).mean(dim=-1, keepdim=True)
    else:
        var = mesh.enter(mesh.all_reduce((x * x).sum(dim=-1, keepdim=True),
                                         "sum")) / di
    ob = out.block()
    y = _take(x * (var + cfg.norm_eps) ** -0.5, gb, ob, mesh)
    y = (y * _w(scale, ob, di, mesh).to(torch.float32)).to(dtype)
    return _proj_rows(y, ob, out, mesh)


def mamba2_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[SSMCache], mesh=None
                   ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """As :func:`mamba1_prefill` (``cache`` None: a zero state, none
    kept)."""
    bsz, t, _ = x.shape
    n, pd = cfg.ssm_state, cfg.ssm_head_dim
    tail = []

    def conv(conv_in):
        tail.append(_conv_tail(conv_in, cfg.ssm_conv))
        return F.silu(_causal_conv(conv_in, spmd.local(p["conv_w"]),
                                   spmd.local(p["conv_b"]))
                      ).to(torch.float32), None

    z, _, xh, bmat, cmat, dt, a, d_skip, hb = _mamba2_heads(
        cfg, p, _proj_in(x, p["in_proj"]), conv, cache, mesh)
    hn = hb[1] - hb[0]
    decay = torch.exp(dt * a)[..., None, None]              # (B,T,h,1,1)
    dtx = dt[..., None] * xh                                # (B,T,h,P)
    y = torch.empty_like(xh)
    h_last = None if cache is None else torch.empty_like(cache.ssm_state)
    for c in _blocks(hn, bsz * t * pd * n * 4):
        contrib = dtx[:, :, c, :, None] * bmat[:, :, None, None, :]
        h = _assoc_scan(decay[:, :, c], contrib,
                        None if cache is None else cache.ssm_state[:, c])
        y[:, :, c] = torch.einsum("bthpn,btn->bthp", h, cmat)
        if cache is not None:
            h_last[:, c] = h[:, -1]
        del contrib, h
    y = y + d_skip[:, None] * xh
    out = _gate_out(p, cfg, y.reshape(bsz, t, hn * pd), z, hb, x.dtype,
                    mesh)
    if cache is not None:
        _write_state(cache, tail[0], h_last, t, None)
    return out, cache


def mamba2_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                  live: Optional[torch.Tensor] = None, mesh=None
                  ) -> Tuple[torch.Tensor, SSMCache]:
    bsz = x1.shape[0]
    pd = cfg.ssm_head_dim

    def conv(conv_in):
        y, state = _conv_step(conv_in, cache.conv_state,
                              spmd.local(p["conv_w"]), spmd.local(p["conv_b"]))
        return F.silu(y.to(torch.float32)), state

    z, conv_state, xh, bmat, cmat, dt, a, d_skip, hb = _mamba2_heads(
        cfg, p, _proj_in(x1[:, 0], p["in_proj"]), conv, cache, mesh)
    decay = torch.exp(dt * a)[..., None, None]              # (B, h, 1, 1)
    contrib = (dt[..., None] * xh)[..., None] * bmat[:, None, None, :]
    h = decay * cache.ssm_state + contrib                   # (B, h, P, N)
    y = torch.einsum("bhpn,bn->bhp", h, cmat) + d_skip[:, None] * xh
    out = _gate_out(p, cfg, y.reshape(bsz, (hb[1] - hb[0]) * pd), z, hb,
                    x1.dtype, mesh)[:, None]
    _write_state(cache, conv_state, h, 1, live)
    return out, cache


def mamba_prefill(p, cfg: ModelConfig, x: torch.Tensor,
                  cache: Optional[SSMCache], mesh=None):
    fn = mamba1_prefill if cfg.ssm_version == 1 else mamba2_prefill
    return fn(p, cfg, x, cache, mesh)


def mamba_decode(p, cfg: ModelConfig, x1: torch.Tensor, cache: SSMCache,
                 live: Optional[torch.Tensor] = None, mesh=None):
    fn = mamba1_decode if cfg.ssm_version == 1 else mamba2_decode
    return fn(p, cfg, x1, cache, live, mesh)
