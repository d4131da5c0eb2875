"""Mixture-of-Experts layer with sort-based capacity dispatch and DyMoE
mixed-precision expert execution (torch twin of
``repro/models/layers/moe.py``).

Tokens are routed top-k, given a slot in their expert's capacity buffer by
a running count, scattered into an (E, C, d) buffer, run through the
packed-expert matmuls, and gathered back weighted by their gates.

  * ``moe_apply`` — one shared Critical mask (the solo admission prefill):
    three ``expert_quant_matmul`` (K2) launches per layer; without a mask,
    the full-precision SwiGLU over the float expert weights (DyMoE off).
  * ``moe_apply_sharded`` — the data-local dispatch
    (``cfg.moe_dispatch_shards``): ``moe_apply`` on each of D token groups,
    their capacity buffers folded into one, so still three K2 launches.
  * ``moe_apply_rows`` — decode, every row with its own Critical mask: one
    combined hi/lo capacity buffer per expert and three
    ``expert_quant_matmul_grouped`` (K1) launches per layer.
  * ``moe_apply_prefill_rows`` — the batched admission wave: the same
    combined buffer at prefill shapes, with per-row solo capacities.

Under grads (the train step) the expert inputs enter a rank's experts or
columns through ``Mesh.enter`` and the gathers carry their adjoints
(``launch/mesh.py``); ``moe_apply_sharded``'s gather over "data" sums the
data ranks' grads of the gathered tokens, so the router losses, computed
from the whole batch's statistics, reach every rank's rows.

Under a mesh (``sharding/spmd.py``) the routed stores may be split over
E (expert-parallel: a rank runs its E/n experts, then the (E, M, dm)
output is gathered exactly, so the combine is the one-device combine) or
within each expert (the N of a quantized store, the d_ff of a float one);
routing, slots and watermarks are computed whole on every rank.

Parity traps handled here (each named where it is handled):
  * ties — router top-k through :func:`stable_topk`;
  * capacities — ``_capacity`` is host Python-float arithmetic;
  * scatter — ``.at[...].add(mode="drop")`` becomes
    ``index_put_(accumulate=True)`` on the same clipped slots, and the
    scatter-max watermark ``scatter_reduce("amax")``;
  * cast order — gates are cast to x's dtype before the product, as in
    ``ye * gates.astype(x.dtype)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.importance import stable_topk
from repro_torch.models.config import ModelConfig
from repro_torch.quant.mixed import mixed_precision_matmul
from repro_torch.quant.qtensor import MixedPrecisionWeights
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import Shard

__all__ = ["moe_apply", "moe_apply_sharded", "moe_apply_rows",
           "moe_apply_prefill_rows", "quantize_moe", "MoEStats"]


@dataclasses.dataclass
class MoEStats:
    """Per-layer routing statistics consumed by DyMoE core."""

    router_logits: torch.Tensor      # (T, E)
    expert_load: torch.Tensor        # (E,)
    expert_hh_load: torch.Tensor     # (E,)
    gate_mean: torch.Tensor          # (E,)
    aux_loss: torch.Tensor           # scalar
    dropped_frac: torch.Tensor       # scalar


def quantize_moe(p, cfg: ModelConfig,
                 names=("w_gate", "w_up", "w_down")) -> dict:
    """Mixed-precision variants of the routed expert weights (router and
    shared experts stay in working precision)."""
    pol = cfg.dymoe
    return {name: MixedPrecisionWeights.build(p[name], pol.high_bits,
                                              pol.low_bits or None,
                                              pol.group_size)
            for name in names}


def _capacity(cfg: ModelConfig, t: int) -> int:
    # parity trap — capacities: HOST Python-float (f64) arithmetic, so the
    # truncation is exact and identical to the JAX package's; the
    # scheduler passes these exact values as ``row_capacities``.
    c = int(cfg.capacity_factor * t * cfg.num_experts_per_tok
            / cfg.num_experts)
    return min(t, max(8, c))


def _route(p, cfg: ModelConfig, x: torch.Tensor):
    """Router: (T, E) f32 logits and probs, stable top-k gates/experts."""
    logits = x.to(torch.float32) @ p["wg_router"]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = stable_topk(probs, cfg.num_experts_per_tok)  # ties: low idx
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def _scatter(shape, dtype, device, e_idx, slot, rows):
    """``zeros(shape).at[e_idx, slot].add(rows, mode="drop")``: the slot
    indices are already clipped in range, so nothing drops."""
    buf = torch.zeros(shape, dtype=dtype, device=device)
    return buf.index_put_((e_idx, slot), rows.to(dtype), accumulate=True)


def _swiglu(mm, xb: torch.Tensor) -> torch.Tensor:
    h = F.silu(mm("w_gate", xb)) * mm("w_up", xb)
    return mm("w_down", h)


def _expert_block(w):
    """(mesh, first expert, end) of this rank's experts when the routed
    store ``w`` (float (E, K, N) or quantized) is split over E
    (expert-parallel), else None."""
    if isinstance(w, MixedPrecisionWeights):
        if spmd.mp_split(w) != "e":
            return None
        w = w.high.packed
    elif not isinstance(w, Shard) or w.dim != w.local.dim() - 3:
        return None
    lo, hi = w.block()
    return w.mesh, lo, hi


def _expert_swiglu(ws: dict, xb: torch.Tensor, mm) -> torch.Tensor:
    """SwiGLU over the capacity buffer ``xb`` (E, M, dm) through the routed
    stores ``ws`` (float or quantized), whole or split over a mesh:
    ``mm(name, h, e0, e1)`` runs ``h``, the buffer of experts [e0, e1),
    through this rank's block of ``ws[name]``.

    Expert-parallel, each rank runs only its E/n experts and the (E, M,
    dm) output is assembled by an exact gather, so the combine that
    follows is the one-device combine. Split within the experts (N of a
    quantized store, d_ff of a float one), every rank runs every expert on
    its columns, gathered (or, for the float pair, summed) as
    ``sharding/spmd.py`` sets out. Whole stores run as on one device."""
    blk = _expert_block(ws["w_gate"])
    if blk is not None:
        mesh, lo, hi = blk
        y = _swiglu(lambda name, h: mm(name, h, lo, hi),
                    mesh.enter(xb)[lo:hi])
        return mesh.all_gather(y.contiguous(), 0)
    e = xb.shape[0]
    xb = spmd.enter_cols(xb, ws["w_up"])
    h = F.silu(mm("w_gate", xb, 0, e)) * mm("w_up", xb, 0, e)
    h = spmd.to_down(h, ws["w_up"], ws["w_down"])
    return spmd.from_down(mm("w_down", h, 0, e), ws["w_down"])


def _expert_ffn(p, xb: torch.Tensor) -> torch.Tensor:
    """Full-precision SwiGLU, (E, C, dm) -> (E, C, dm): the JAX package
    computes it outside any Pallas kernel, as these batched products."""
    return _expert_swiglu(p, xb, lambda name, h, lo, hi: torch.bmm(
        h, spmd.local(p[name])))


def _expert_ffn_fixed(qweights: dict, prec: str,
                      xb: torch.Tensor) -> torch.Tensor:
    """SwiGLU with every expert at one fixed precision — the two-dispatch
    oracle of the fused path."""
    from repro_torch.kernels.quant_matmul.ops import expert_quant_matmul_fixed
    return _expert_swiglu(qweights, xb, lambda name, h, lo, hi:
                          expert_quant_matmul_fixed(
                              h, getattr(spmd.local_mp(qweights[name]),
                                         prec), out_dtype=xb.dtype))


def _expert_ffn_grouped(qweights: dict, xb: torch.Tensor,
                        counts: torch.Tensor, *, cap_hi: int) -> torch.Tensor:
    """SwiGLU over ONE combined dual-precision capacity buffer: three K1
    launches, each walking the hi region ``[0, cap_hi)`` and the lo region
    ``[cap_hi, M)``, skipping rows past the (E, 2) watermarks."""
    from repro_torch.kernels.quant_matmul.ops import \
        expert_quant_matmul_grouped
    return _expert_swiglu(qweights, xb, lambda name, h, lo, hi:
                          expert_quant_matmul_grouped(
                              h, spmd.local_mp(qweights[name]),
                              counts[lo:hi], cap_hi=cap_hi,
                              out_dtype=xb.dtype))


def _expert_ffn_quantized(qw: dict, critical: torch.Tensor,
                          xb: torch.Tensor) -> torch.Tensor:
    """SwiGLU at the precision ``critical`` (E,) selects: three K2
    launches; "4/0" zeroes sub-critical experts inside the kernel."""
    return _expert_swiglu(qw, xb, lambda name, h, lo, hi:
                          mixed_precision_matmul(
                              h, spmd.local_mp(qw[name]), critical[lo:hi],
                              skip_to_zero=True, out_dtype=xb.dtype))


def _shared_experts(p, x: torch.Tensor) -> torch.Tensor:
    """Always-active shared experts (Qwen2-MoE): (T, dm) -> (T, dm); under
    a mesh a Megatron pair over d_ff (one SUM)."""
    up, down = p["shared_w_up"], p["shared_w_down"]
    x = spmd.enter_cols(x, up)
    hs = F.silu(torch.einsum("td,edf->etf", x,
                             spmd.local(p["shared_w_gate"])))
    hs = hs * torch.einsum("td,edf->etf", x, spmd.local(up))
    hs = spmd.to_down(hs, up, down)
    return spmd.from_down(
        torch.einsum("etf,efd->td", hs, spmd.local(down)), down)


def _one_hot(idx: torch.Tensor, e: int, dtype) -> torch.Tensor:
    return F.one_hot(idx, e).to(dtype)


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jnp.repeat(x, k, axis=0)`` as a broadcast view + copy (an integer
    ``repeat_interleave`` may read a size back from the device)."""
    return x.unsqueeze(1).expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


@dataclasses.dataclass
class _Routed:
    """One token group's routing and its (E, C, dm) capacity buffer."""

    logits: torch.Tensor
    probs: torch.Tensor
    gates: torch.Tensor
    idx: torch.Tensor
    flat_e: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    valid_rep: Optional[torch.Tensor]
    buf: torch.Tensor


def _dispatch(p, cfg: ModelConfig, x: torch.Tensor,
              token_valid: Optional[torch.Tensor]) -> _Routed:
    """Route x (T, dm) top-k and give each (token, k) pair a slot of its
    expert's capacity ``_capacity(cfg, T)`` by a running count."""
    t, dm = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    c = _capacity(cfg, t)
    logits, probs, gates, idx = _route(p, cfg, x)
    flat_e = idx.reshape(-1)                                  # (T*k,)
    oh = _one_hot(flat_e, e, torch.int64)                     # (T*k, E)
    valid_rep = None
    if token_valid is not None:
        valid_rep = _rep(token_valid.to(torch.bool), k)
        oh = oh * valid_rep[:, None]
    pos = torch.cumsum(oh, dim=0) - 1
    pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos_in_e < c
    if token_valid is not None:
        keep = keep & valid_rep
    slot = torch.clamp(pos_in_e, 0, c - 1)
    tok = _rep(torch.arange(t, device=x.device), k)
    xb = torch.where(keep[:, None], x[tok], torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    return _Routed(logits, probs, gates, idx, flat_e, slot, keep, valid_rep,
                   _scatter((e, c, dm), x.dtype, x.device, flat_e, slot, xb))


def _experts(p, buf: torch.Tensor, critical_mask: Optional[torch.Tensor],
             qweights: Optional[dict]) -> torch.Tensor:
    """The routed experts over a capacity buffer (E, M, dm): three K2
    launches at the precision ``critical_mask`` selects, or the float
    SwiGLU without a mask."""
    if critical_mask is not None:
        assert qweights is not None
        return _expert_ffn_quantized(qweights, critical_mask, buf)
    return _expert_ffn(p, buf)


def _combine(p, cfg: ModelConfig, x: torch.Tensor, r: _Routed,
             yb: torch.Tensor, hh_mask: Optional[torch.Tensor],
             token_valid: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, MoEStats]:
    """Gather each kept pair's expert output back to its token, weighted
    by its gate (plus the shared experts), and the group's statistics."""
    t, dm = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    ye = torch.where(r.keep[:, None], yb[r.flat_e, r.slot],
                     torch.zeros((), dtype=yb.dtype, device=x.device))
    ye = ye * r.gates.reshape(-1, 1).to(x.dtype)              # cast order
    y = ye.reshape(t, k, dm).sum(dim=1)
    if cfg.num_shared_experts:
        y = y + _shared_experts(p, x)

    onehot_top = _one_hot(r.idx, e, torch.float32)            # (T, k, E)
    lse2 = torch.logsumexp(r.logits, dim=-1) ** 2
    if token_valid is not None:
        tv = token_valid.to(torch.float32)
        onehot_top = onehot_top * tv[:, None, None]
        n_valid = torch.clamp(tv.sum(), min=1.0)
        frac_probs = torch.einsum("te,t->e", r.probs, tv) / n_valid
        z_loss = (lse2 * tv).sum() / n_valid
        dropped = 1.0 - r.keep.sum() / torch.clamp(r.valid_rep.sum(), min=1)
    else:
        frac_probs = r.probs.mean(dim=0)
        z_loss = lse2.mean()
        dropped = 1.0 - r.keep.to(torch.float32).mean()
    load = onehot_top.sum(dim=(0, 1))                         # (E,)
    frac_tokens = load / torch.clamp(load.sum(), min=1.0)
    lb_loss = e * (frac_tokens * frac_probs).sum()
    aux = cfg.router_aux_coef * lb_loss + cfg.router_z_coef * z_loss
    if hh_mask is None:
        hh_mask = torch.zeros((t,), dtype=torch.float32, device=x.device)
    hh_load = torch.einsum("tke,t->e", onehot_top, hh_mask.to(torch.float32))
    gate_sum = torch.einsum("tke,tk->e", onehot_top,
                            r.gates.to(torch.float32))
    gate_mean = gate_sum / torch.clamp(load, min=1.0)
    return y, MoEStats(router_logits=r.logits, expert_load=load,
                       expert_hh_load=hh_load, gate_mean=gate_mean,
                       aux_loss=aux, dropped_frac=dropped)


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *,
              critical_mask: Optional[torch.Tensor] = None,
              qweights: Optional[dict] = None,
              hh_mask: Optional[torch.Tensor] = None,
              token_valid: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, MoEStats]:
    """The MoE layer on flattened tokens x (T, dm) with one Critical mask
    (E,) over ``qweights``; ``critical_mask=None`` runs the float expert
    weights (full precision). ``token_valid`` (T,) False marks padding: no
    slot, zero output, no routing statistics. Returns (y (T, dm),
    MoEStats)."""
    r = _dispatch(p, cfg, x, token_valid)
    yb = _experts(p, r.buf, critical_mask, qweights)          # (E, C, dm)
    return _combine(p, cfg, x, r, yb, hh_mask, token_valid)


def dispatch_axes(cfg: ModelConfig, mesh) -> None:
    """Check ``cfg.moe_dispatch_axes`` against ``mesh``: every axis it
    names is one of the mesh's batch axes ("pod", "data"), every batch
    axis above 1 is named, and ``cfg.moe_dispatch_shards`` is a multiple
    of their size (each data rank runs D / d of the D groups); raises
    ``ValueError`` otherwise. Nothing to check without axes or a mesh."""
    axes = tuple(cfg.moe_dispatch_axes or ())
    if not axes or mesh is None:
        return
    batch = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if any(a not in batch for a in axes) or any(
            mesh.shape[a] > 1 and a not in axes for a in batch):
        raise ValueError(
            f"moe_dispatch_axes={axes} must name the batch axes {batch} of "
            f"a {mesh.shape} mesh (every one above 1)")
    if cfg.moe_dispatch_shards % mesh.data_size:
        raise ValueError(
            f"moe_dispatch_shards={cfg.moe_dispatch_shards} is not a "
            f"multiple of the {mesh.data_size} data ranks of "
            f"{mesh.shape} that moe_dispatch_axes={axes} pins its groups to")


def local_dispatch(cfg: ModelConfig, mesh, t: int) -> bool:
    """Whether a one-mask MoE site over this rank's ``t`` tokens of a
    batch split over ``mesh``'s data axes dispatches them where they are:
    ``cfg.moe_dispatch_axes`` pins the D groups to the data ranks
    (:func:`dispatch_axes` checks them) and D divides the global tokens.
    Otherwise the site keeps the global capacity and token order by
    gathering its tokens over "data"."""
    if mesh is None or mesh.data_size == 1 or not cfg.moe_dispatch_axes:
        return False
    dispatch_axes(cfg, mesh)
    d = cfg.moe_dispatch_shards
    return d > 1 and (t * mesh.data_size) % d == 0


def _grouped(p, cfg: ModelConfig, x: torch.Tensor, d: int, hh_mask,
             critical_mask, qweights, token_valid):
    """``moe_apply`` on each of ``d`` contiguous token groups of ``x``,
    their capacity buffers folded into one (E, d·C_d, dm) buffer (one K2
    launch an expert matmul). Returns (y, per-group MoEStats)."""
    t = x.shape[0]
    xs = x.reshape(d, t // d, -1)
    hh = hh_mask.reshape(d, t // d) if hh_mask is not None else None
    tv = token_valid.reshape(d, t // d) if token_valid is not None else None
    routed = [_dispatch(p, cfg, xs[i], None if tv is None else tv[i])
              for i in range(d)]
    c = routed[0].buf.shape[1]
    yb = _experts(p, _cat([r.buf for r in routed], 1),
                  critical_mask, qweights)                    # (E, D·C, dm)
    outs = [_combine(p, cfg, xs[i], r, yb[:, i * c:(i + 1) * c],
                     None if hh is None else hh[i],
                     None if tv is None else tv[i])
            for i, r in enumerate(routed)]
    return _cat([o[0] for o in outs], 0), [o[1] for o in outs]


def _cat(ts, dim: int) -> torch.Tensor:
    """``torch.cat``, without the copy of a single tensor."""
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim)


def _merge(router_logits: torch.Tensor, load, hh_load, gate_mean, aux,
           dropped) -> MoEStats:
    """The groups' statistics merged as the JAX package merges its vmap's:
    loads summed, gate means, aux losses and dropped shares averaged."""
    return MoEStats(router_logits=router_logits, expert_load=load.sum(0),
                    expert_hh_load=hh_load.sum(0), gate_mean=gate_mean.mean(0),
                    aux_loss=aux.mean(), dropped_frac=dropped.mean())


def moe_apply_sharded(p, cfg: ModelConfig, x: torch.Tensor, *,
                      hh_mask: Optional[torch.Tensor] = None,
                      critical_mask: Optional[torch.Tensor] = None,
                      qweights: Optional[dict] = None,
                      token_valid: Optional[torch.Tensor] = None,
                      mesh=None,
                      ) -> Tuple[torch.Tensor, MoEStats]:
    """Data-local MoE dispatch: the T tokens split into D =
    ``cfg.moe_dispatch_shards`` contiguous groups, each routed as its own
    :func:`moe_apply` with capacity ``_capacity(cfg, T / D)``, its own
    ``hh_mask`` and ``token_valid`` rows and the one shared
    ``critical_mask``. Falls back to :func:`moe_apply` when D <= 1 or D
    does not divide T.

    The D groups' (E, C_d, dm) buffers are folded into ONE (E, D·C_d, dm)
    buffer, so each expert matmul stays one K2 launch (three a layer), as
    the JAX package's ``vmap`` over its kernel is one call; a row's
    output does not depend on the rows beside it. Statistics merge as the
    JAX package's do: loads summed, gate means, aux losses and dropped
    shares averaged over the groups, router logits back to (T, E).

    ``mesh``: ``x`` (and ``hh_mask``, ``token_valid``) are this rank's
    tokens of a batch split over the mesh's data axes (``Mesh.for_batch``;
    a mesh whose data axes are 1 changes nothing here). With
    ``cfg.moe_dispatch_axes`` naming them (:func:`local_dispatch`), the
    rank runs only its D / d groups, as the reference pins them to the
    data shards, and the groups' statistics are gathered over "data" (one
    collective) and merged as on one device; the router logits stay this
    rank's (T / d, E). Otherwise the tokens are gathered over "data", the
    dispatch runs as one rank would (global capacity and token order) and
    the rank keeps its rows of the output and of the router logits."""
    split = mesh is not None and mesh.data_size > 1
    d = cfg.moe_dispatch_shards
    t = x.shape[0]
    if split and local_dispatch(cfg, mesh, t):
        dl = d // mesh.data_size
        y, st = _grouped(p, cfg, x, dl, hh_mask, critical_mask, qweights,
                         token_valid)
        e = cfg.num_experts
        rows = torch.cat([torch.stack([s.expert_load for s in st]),
                          torch.stack([s.expert_hh_load for s in st]),
                          torch.stack([s.gate_mean for s in st]),
                          torch.stack([s.aux_loss for s in st])[:, None],
                          torch.stack([s.dropped_frac.to(torch.float32)
                                       for s in st])[:, None]], dim=1)
        g = mesh.all_gather(rows.to(torch.float32), 0, axis="data")
        return y, _merge(_cat([s.router_logits for s in st], 0),
                         g[:, :e], g[:, e:2 * e], g[:, 2 * e:3 * e],
                         g[:, 3 * e], g[:, 3 * e + 1])
    if split:
        gather = [v for v in (x, hh_mask, token_valid) if v is not None]
        whole = iter([mesh.all_gather(v, 0, axis="data") for v in gather])
        xg = next(whole)
        hg = next(whole) if hh_mask is not None else None
        tg = next(whole) if token_valid is not None else None
        y, stats = moe_apply_sharded(p, cfg, xg, hh_mask=hg,
                                     critical_mask=critical_mask,
                                     qweights=qweights, token_valid=tg)
        lo = mesh.data_rank * t
        return y[lo:lo + t], dataclasses.replace(
            stats, router_logits=stats.router_logits[lo:lo + t])
    if d <= 1 or t % d != 0:
        return moe_apply(p, cfg, x, hh_mask=hh_mask,
                         critical_mask=critical_mask, qweights=qweights,
                         token_valid=token_valid)
    y, st = _grouped(p, cfg, x, d, hh_mask, critical_mask, qweights,
                     token_valid)
    return y, _merge(torch.cat([s.router_logits for s in st]),
                     torch.stack([s.expert_load for s in st]),
                     torch.stack([s.expert_hh_load for s in st]),
                     torch.stack([s.gate_mean for s in st]),
                     torch.stack([s.aux_loss for s in st]),
                     torch.stack([s.dropped_frac for s in st]))


def moe_apply_rows(p, cfg: ModelConfig, x: torch.Tensor,
                   critical_rows: torch.Tensor, qweights: dict, *,
                   live: Optional[torch.Tensor] = None,
                   capacity: Optional[int] = None,
                   fused: bool = True) -> Tuple[torch.Tensor, dict]:
    """Decode-time MoE where every row carries its own Critical mask.

    Each (token, expert) pair lands in the hi or the lo region of ONE
    capacity buffer per expert, packed from slot 0 so the per-expert
    occupancy IS the kernel's live-row watermark; the whole buffer runs
    one fused K1 launch per expert matmul. ``live`` (B,) False rows take
    no slot and come back exactly zero; ``capacity`` (requires ``live``)
    shrinks each region from B to the chunk's live-row bound.
    ``fused=False`` is the two-dispatch bit-parity oracle.

    x: (B, dm); critical_rows: (B, E) bool. Returns (y (B, dm), per-row
    stats {"active" (B, E) bool, "gate_mean" (B, E), "router_logits"})."""
    b, dm = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    if capacity is None:
        c = b
    else:
        assert live is not None, \
            "capacity < B requires the live mask that bounds occupancy"
        c = max(1, min(int(capacity), b))
    logits, _, gates, idx = _route(p, cfg, x)

    crit_tok = torch.gather(critical_rows.to(torch.bool), 1, idx)
    flat_e = idx.reshape(-1)                                  # (B*k,)
    flat_c = crit_tok.reshape(-1)
    oh = _one_hot(flat_e, e, torch.int64)                     # (B*k, E)
    if live is not None:
        live_rep = _rep(live.to(torch.bool), k)
        sel_hi, sel_lo = flat_c & live_rep, ~flat_c & live_rep
    else:
        sel_hi, sel_lo = flat_c, ~flat_c
    tok = _rep(torch.arange(b, device=dev), k)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    def place(select):
        """Slot inside the (expert, precision) region and the per-expert
        occupancy (selected pairs pack from slot 0)."""
        ohs = oh * select[:, None]
        pos = torch.cumsum(ohs, dim=0) - 1
        pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
        n = torch.clamp(ohs.sum(dim=0), max=c).to(torch.int32)
        return torch.clamp(pos_in_e, 0, c - 1), n

    skip_low = qweights["w_gate"].low is None                 # "4/0"
    slot_hi, n_hi = place(sel_hi)
    xb_hi = torch.where(sel_hi[:, None], x[tok], zero)
    if fused:
        buf = _scatter((e, c if skip_low else 2 * c, dm), x.dtype, dev,
                       flat_e, slot_hi, xb_hi)
        if skip_low:
            counts = torch.stack([n_hi, torch.zeros_like(n_hi)], dim=1)
            yb = _expert_ffn_grouped(qweights, buf, counts, cap_hi=c)
            ye = torch.where(sel_hi[:, None], yb[flat_e, slot_hi], zero)
        else:
            slot_lo, n_lo = place(sel_lo)
            xb_lo = torch.where(sel_lo[:, None], x[tok], zero)
            buf.index_put_((flat_e, c + slot_lo), xb_lo, accumulate=True)
            counts = torch.stack([n_hi, n_lo], dim=1)
            yb = _expert_ffn_grouped(qweights, buf, counts, cap_hi=c)
            ye = torch.where(sel_hi[:, None], yb[flat_e, slot_hi],
                             torch.where(sel_lo[:, None],
                                         yb[flat_e, c + slot_lo], zero))
    else:
        buf_hi = _scatter((e, c, dm), x.dtype, dev, flat_e, slot_hi, xb_hi)
        y_hi = _expert_ffn_fixed(qweights, "high", buf_hi)
        if skip_low:
            ye = torch.where(sel_hi[:, None], y_hi[flat_e, slot_hi], zero)
        else:
            slot_lo, _ = place(sel_lo)
            xb_lo = torch.where(sel_lo[:, None], x[tok], zero)
            buf_lo = _scatter((e, c, dm), x.dtype, dev, flat_e, slot_lo,
                              xb_lo)
            y_lo = _expert_ffn_fixed(qweights, "low", buf_lo)
            ye = torch.where(sel_hi[:, None], y_hi[flat_e, slot_hi],
                             torch.where(sel_lo[:, None],
                                         y_lo[flat_e, slot_lo], zero))
    ye = ye * gates.reshape(-1, 1).to(x.dtype)                # cast order
    y = ye.reshape(b, k, dm).sum(dim=1)
    if cfg.num_shared_experts:
        y = y + _shared_experts(p, x)

    onehot_top = _one_hot(idx, e, torch.float32)              # (B, k, E)
    load = onehot_top.sum(dim=1)                              # (B, E)
    gate_sum = torch.einsum("bke,bk->be", onehot_top, gates.to(torch.float32))
    return y, dict(active=load > 0,
                   gate_mean=gate_sum / torch.clamp(load, min=1.0),
                   router_logits=logits)


def moe_apply_prefill_rows(p, cfg: ModelConfig, x: torch.Tensor,
                           critical_rows: torch.Tensor, qweights: dict, *,
                           rows: int,
                           hh_mask: Optional[torch.Tensor] = None,
                           token_valid: Optional[torch.Tensor] = None,
                           row_capacities: Optional[torch.Tensor] = None,
                           fused: bool = True,
                           ) -> Tuple[torch.Tensor, dict]:
    """Prefill-shaped MoE where every ROW carries its own Critical mask
    (the batched admission wave). Each token inherits its row's (rows, E)
    mask and lands in a row-local hi or lo slot of one combined capacity
    buffer per expert; capacity is enforced per row at the row's own solo
    budget with the solo slot order, so a token drops here iff its solo
    prefill drops it. Per-(expert, region) watermarks (highest occupied
    slot + 1) bound the kernel's live rows.

    x: (T, dm) flattened from (rows, S); critical_rows: (rows, E) bool;
    hh_mask/token_valid: (T,). ``row_capacities`` (rows,) pins each row's
    capacity to the exact host ``_capacity(cfg, len_i)`` (the in-graph f32
    formula can truncate one slot differently). Returns (y (T, dm), stats
    {"active"/"load"/"hh_load"/"gate_mean" (rows, E), "router_logits"
    (T, E), "aux_loss", "dropped_frac"})."""
    t, dm = x.shape
    b = rows
    assert t % b == 0, (t, b)
    s = t // b
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dev = x.device
    cmax = _capacity(cfg, s)      # static per-row buffer stride (>= c_row)
    logits, probs, gates, idx = _route(p, cfg, x)

    flat_e = idx.reshape(-1)                                  # (T*k,)
    row_rep = _rep(torch.arange(b, device=dev), s * k)
    crit_tok = torch.gather(
        _rep(critical_rows.to(torch.bool), s), 1, idx)
    flat_c = crit_tok.reshape(-1)
    if token_valid is not None:
        valid_rep = _rep(token_valid.to(torch.bool), k)
        lens = token_valid.to(torch.int32).reshape(b, s).sum(dim=1)
    else:
        valid_rep = torch.ones((t * k,), dtype=torch.bool, device=dev)
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    if row_capacities is not None:
        c_row = torch.as_tensor(row_capacities, device=dev).to(torch.int64)
    else:
        c_row = torch.minimum(lens, torch.clamp(
            (torch.tensor(cfg.capacity_factor, dtype=torch.float32)
             * lens.to(torch.float32) * k / e).to(torch.int32),
            min=8)).to(torch.int64)
    oh = _one_hot(flat_e, e, torch.int64)                     # (T*k, E)
    tok_of = _rep(torch.arange(t, device=dev), k)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    def stream_pos(select):
        """Within-ROW running slot of each (token, k) pair in the selected
        stream (cumsum restarts at row boundaries: the solo order), and
        the keep mask at the row's solo capacity."""
        ohs = oh * select[:, None]
        pos = torch.cumsum(ohs.reshape(b, s * k, e), dim=1
                           ).reshape(t * k, e) - 1
        pos_in_e = torch.gather(pos, 1, flat_e[:, None])[:, 0]
        return pos_in_e, select & (pos_in_e < c_row[row_rep])

    def dispatch(select):
        pos_in_e, keep = stream_pos(select)
        slot = row_rep * cmax + torch.clamp(pos_in_e, 0, cmax - 1)
        xb = torch.where(keep[:, None], x[tok_of], zero)
        return _scatter((e, b * cmax, dm), x.dtype, dev, flat_e, slot,
                        xb), slot, keep

    sel_hi = flat_c & valid_rep
    sel_lo = ~flat_c & valid_rep
    skip_low = qweights["w_gate"].low is None                 # "4/0"
    if fused:
        cap = b * cmax

        def watermark(keep, slot):
            """Highest occupied slot + 1 per expert (scatter-max)."""
            return torch.zeros((e,), dtype=torch.int64, device=dev
                               ).scatter_reduce(
                0, flat_e, torch.where(keep, slot + 1, 0), "amax"
            ).to(torch.int32)

        buf_hi, slot_hi, keep_hi = dispatch(sel_hi)
        if skip_low:
            counts = torch.stack([watermark(keep_hi, slot_hi),
                                  torch.zeros((e,), dtype=torch.int32,
                                              device=dev)], dim=1)
            y_all = _expert_ffn_grouped(qweights, buf_hi, counts, cap_hi=cap)
            ye = torch.where(keep_hi[:, None], y_all[flat_e, slot_hi], zero)
            _, keep_lo = stream_pos(sel_lo)  # stats only: solo counts these
        else:
            pos_lo, keep_lo = stream_pos(sel_lo)
            slot_lo = row_rep * cmax + torch.clamp(pos_lo, 0, cmax - 1)
            xbl = torch.where(keep_lo[:, None], x[tok_of], zero)
            buf = torch.cat([buf_hi, torch.zeros_like(buf_hi)], dim=1)
            buf.index_put_((flat_e, cap + slot_lo), xbl, accumulate=True)
            counts = torch.stack([watermark(keep_hi, slot_hi),
                                  watermark(keep_lo, slot_lo)], dim=1)
            y_all = _expert_ffn_grouped(qweights, buf, counts, cap_hi=cap)
            ye = torch.where(keep_hi[:, None], y_all[flat_e, slot_hi],
                             torch.where(keep_lo[:, None],
                                         y_all[flat_e, cap + slot_lo], zero))
    else:
        buf_hi, slot_hi, keep_hi = dispatch(sel_hi)
        y_hi = _expert_ffn_fixed(qweights, "high", buf_hi)
        ye_hi = torch.where(keep_hi[:, None], y_hi[flat_e, slot_hi], zero)
        if skip_low:
            ye = ye_hi
            _, keep_lo = stream_pos(sel_lo)  # stats only
        else:
            buf_lo, slot_lo, keep_lo = dispatch(sel_lo)
            y_lo = _expert_ffn_fixed(qweights, "low", buf_lo)
            ye = torch.where(flat_c[:, None], ye_hi,
                             torch.where(keep_lo[:, None],
                                         y_lo[flat_e, slot_lo], zero))
    ye = ye * gates.reshape(-1, 1).to(x.dtype)                # cast order
    y = ye.reshape(t, k, dm).sum(dim=1)
    if cfg.num_shared_experts:
        y = y + _shared_experts(p, x)

    # ----- per-row statistics (each row's block == its solo stats) -----
    onehot_top = _one_hot(idx, e, torch.float32)              # (T, k, E)
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if token_valid is not None:
        tv = token_valid.to(torch.float32)
        onehot_top = onehot_top * tv[:, None, None]
        n_valid = torch.clamp(tv.sum(), min=1.0)
        frac_probs = torch.einsum("te,t->e", probs, tv) / n_valid
        z_loss = (lse2 * tv).sum() / n_valid
    else:
        frac_probs = probs.mean(dim=0)
        z_loss = lse2.mean()
    kept = keep_hi | keep_lo
    dropped = 1.0 - kept.sum() / torch.clamp(valid_rep.sum(), min=1)
    oh_r = onehot_top.reshape(b, s, k, e)
    load = oh_r.sum(dim=(1, 2))                               # (B, E)
    if hh_mask is None:
        hh_mask = torch.zeros((t,), dtype=torch.float32, device=dev)
    hh_load = torch.einsum("bske,bs->be", oh_r,
                           hh_mask.to(torch.float32).reshape(b, s))
    gate_sum = torch.einsum("bske,bsk->be", oh_r,
                            gates.to(torch.float32).reshape(b, s, k))
    gate_mean = gate_sum / torch.clamp(load, min=1.0)
    load_all = load.sum(dim=0)
    frac_tokens = load_all / torch.clamp(load_all.sum(), min=1.0)
    lb_loss = e * (frac_tokens * frac_probs).sum()
    aux = cfg.router_aux_coef * lb_loss + cfg.router_z_coef * z_loss
    return y, dict(active=load > 0, load=load, hh_load=hh_load,
                   gate_mean=gate_mean, router_logits=logits,
                   aux_loss=aux, dropped_frac=dropped)
