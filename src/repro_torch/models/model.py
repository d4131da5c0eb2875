"""Top-level MoE model of the port: init, quantization, prefill and the
continuous-batching decode (torch twin of ``repro/models/model.py`` for
the ``attn_moe`` block kind under DyMoE mixed precision).

Per-layer parameters are STACKED with a leading L dim, as in the JAX
package; a Python loop over the layers takes the place of ``lax.scan``.
Layer pattern (pre-norm residual): x += Attn(n1(x)); x += MoE(n2(x)).

DyMoE on the inference paths:
  * prefill — attention yields the per-token received mass (Eq. 1);
    heavy-hitter routing stats give expert importance (Eq. 2); the depth
    schedule's t_l picks the Critical set (Eq. 4–5); next-layer gate
    predictions (Eq. 6–7) are emitted for the prefetcher. ``row_local``
    picks a Critical set per row (the batched admission wave).
  * decode — per-row gate-guided importance (Eq. 3) and direct prefetch
    (Eq. 8), with a live-row mask that freezes finished rows.

The KV cache is written in place (see ``kv_cache.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.importance import heavy_hitter_mask, \
    prefill_expert_importance, prefill_expert_importance_rows, \
    select_critical, select_critical_rows, stable_topk
from repro_torch.core.prefetch import predict_next_gates, prefetch_targets
from repro_torch.core.schedule import critical_counts
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import KVCache, fill_kv_cache, init_kv_cache
from repro_torch.models.layers.attention import attention_decode, \
    attention_train
from repro_torch.models.layers.moe import moe_apply, \
    moe_apply_prefill_rows, moe_apply_rows, quantize_moe
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.quant.qtensor import MixedPrecisionWeights

__all__ = ["init_params", "quantize_model", "prefill", "decode_step",
           "decode_many_batched", "init_decode_state", "DyMoEInfo"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.block_kinds()[0] != "attn_moe":
        raise NotImplementedError(
            f"{cfg.name}: the port runs MoE architectures only so far")
    if cfg.sliding_window or cfg.pos_emb != "rope" or \
            cfg.moe_dispatch_shards > 1:
        raise NotImplementedError(
            f"{cfg.name}: sliding windows, non-RoPE positions and sharded "
            "MoE dispatch are not ported yet")


def _index_tree(tree, i):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, MixedPrecisionWeights):
        return tree.index(i)
    return tree[i]


# --------------------------------------------------------------------- init


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (on ``device``; ``None`` takes
    the generator's device), stacked along a leading L dim with the JAX
    package's tree layout and init scales.
    Stacked weights are drawn layer by layer, so no full-depth f32
    temporary is built. (Torch RNG cannot reproduce ``jax.random``: tests
    bring JAX-made parameters across with ``repro_torch.params``.)"""
    cfg.validate()
    _check_supported(cfg)
    device = resolve_device(generator.device if device is None else device)
    dt = _dtype(cfg)
    L, dm, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    h, hk, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    e, dff = cfg.num_experts, cfg.expert_d_ff

    def normal(shape, scale, dtype=dt, stacked=True):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0] if stacked else 1):
            dst = out[i] if stacked else out
            dst.copy_(torch.randn(dst.shape, generator=generator,
                                  device=device) * scale)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    attn = {"wq": normal((L, dm, h * d), dm ** -0.5),
            "wk": normal((L, dm, hk * d), dm ** -0.5),
            "wv": normal((L, dm, hk * d), dm ** -0.5),
            "wo": normal((L, h * d, dm), (h * d) ** -0.5)}
    if cfg.qkv_bias:
        for n, w in (("bq", h * d), ("bk", hk * d), ("bv", hk * d)):
            attn[n] = torch.zeros((L, w), dtype=dt, device=device)
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": ones(L, d)}
        attn["k_norm"] = {"scale": ones(L, d)}
    moe = {"wg_router": normal((L, dm, e), dm ** -0.5, torch.float32),
           "w_gate": normal((L, e, dm, dff), dm ** -0.5),
           "w_up": normal((L, e, dm, dff), dm ** -0.5),
           "w_down": normal((L, e, dff, dm), dff ** -0.5)}
    if cfg.num_shared_experts:
        se = cfg.num_shared_experts
        moe["shared_w_gate"] = normal((L, se, dm, dff), dm ** -0.5)
        moe["shared_w_up"] = normal((L, se, dm, dff), dm ** -0.5)
        moe["shared_w_down"] = normal((L, se, dff, dm), dff ** -0.5)
    params = {"embed": normal((V, dm), dm ** -0.5, stacked=False),
              "final_norm": {"scale": ones(dm)},
              "layers": {"norm1": {"scale": ones(L, dm)},
                         "norm2": {"scale": ones(L, dm)},
                         "attn": attn, "moe": moe}}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((dm, V), dm ** -0.5, stacked=False)
    return params


def quantize_model(params, cfg: ModelConfig) -> Dict[str, Any]:
    """DyMoE mixed-precision store of the routed experts (paper §5), with
    the leading L dim kept. Quantized LAYER BY LAYER on the weights'
    device: the full-depth f32 temporary of an OLMoE expert matrix would
    be 8.6 GB."""
    _check_supported(cfg)
    moe = params["layers"]["moe"]
    out = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = moe[name]
        stacked: Optional[MixedPrecisionWeights] = None
        for l in range(w.shape[0]):
            mp = quantize_moe({name: w[l]}, cfg, names=(name,))[name]
            if stacked is None:
                stacked = _alloc_stacked(mp, w.shape[0])
            _copy_layer(stacked, mp, l)
        out[name] = stacked
    return {"layers": {"moe": out}}


def _alloc_stacked(mp: MixedPrecisionWeights,
                   n: int) -> MixedPrecisionWeights:
    def alloc(qt):
        if qt is None:
            return None
        return dataclasses.replace(
            qt, packed=qt.packed.new_empty((n,) + tuple(qt.packed.shape)),
            scales=qt.scales.new_empty((n,) + tuple(qt.scales.shape)))
    return MixedPrecisionWeights(high=alloc(mp.high), low=alloc(mp.low))


def _copy_layer(dst: MixedPrecisionWeights, src: MixedPrecisionWeights,
                l: int) -> None:
    for d, s in ((dst.high, src.high), (dst.low, src.low)):
        if s is not None:
            d.packed[l].copy_(s.packed)
            d.scales[l].copy_(s.scales)


# ------------------------------------------------------------------ helpers


def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def _lm_head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).to(torch.float32)


def _t_l_array(cfg: ModelConfig) -> List[int]:
    return list(critical_counts(cfg.num_layers, max(cfg.num_experts, 1),
                                cfg.dymoe.lam, cfg.dymoe.depth_schedule))


@dataclasses.dataclass
class DyMoEInfo:
    """Per-step DyMoE telemetry."""

    critical_masks: Optional[torch.Tensor] = None   # (L, E) / (L, B, E)
    active_masks: Optional[torch.Tensor] = None
    expert_load: Optional[torch.Tensor] = None
    expert_hh_load: Optional[torch.Tensor] = None
    gate_mean: Optional[torch.Tensor] = None
    predicted_next: Optional[torch.Tensor] = None   # Eq. 6–8 demand
    token_importance: Optional[torch.Tensor] = None  # (B, S), last layer
    aux_loss: Optional[torch.Tensor] = None
    dropped_frac: Optional[torch.Tensor] = None


def _ragged_hh_mask(tok_imp: torch.Tensor, frac: float,
                    lengths: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-row heavy-hitter mask for a right-aligned ragged batch: the
    top-⌈frac·length_i⌉ threshold over row i's real tokens only. Parity
    trap — rounding: ``torch.round`` rounds half to even like ``jnp.round``."""
    ti = torch.where(valid, tok_imp, torch.full_like(tok_imp, -float("inf")))
    k = torch.clamp(torch.round(frac * lengths.to(torch.float32)), min=1
                    ).to(torch.int64)                           # (B,)
    desc = torch.sort(ti, dim=-1, descending=True).values
    thresh = torch.gather(desc, 1, (k - 1)[:, None])
    return ((ti >= thresh) & valid).to(torch.float32)


def _next_router(params, cfg: ModelConfig, l: int) -> torch.Tensor:
    """Layer l+1's router (wrapping to layer 0 for the last layer, whose
    prediction is zeroed afterwards — the JAX package's ``roll``)."""
    return params["layers"]["moe"]["wg_router"][(l + 1) % cfg.num_layers]


# ------------------------------------------------------------------ prefill


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            qparams: dict, cache_slots: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None,
            row_local: bool = False,
            row_capacities: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, KVCache], DyMoEInfo]:
    """Prefill under DyMoE mixed precision. tokens: (B, S) int.

    ``lengths`` (B,) enables RAGGED batches: ``tokens`` is right-aligned
    (row i left-padded with ``S - lengths[i]`` pads), per-row position
    offsets drive RoPE, attention masks pad keys, routing statistics
    exclude pads, and the KV cache records each row's slot offset.

    ``row_local`` (the batched admission wave): each row's Critical set is
    picked from its own Eq. 1–2 importance and experts run through the
    dual-buffer :func:`moe_apply_prefill_rows`, so a row never depends on
    its neighbours; MoE telemetry comes back (L, B, E). ``row_capacities``
    (B,) pins each row's capacity to the host ``_capacity`` value.

    Returns (last-token logits (B, V) f32, {"layers": stacked KVCache},
    DyMoEInfo)."""
    _check_supported(cfg)
    b, s = tokens.shape
    dev = tokens.device
    offsets = valid = positions = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        offsets = torch.full((b,), s, dtype=torch.int32, device=dev) - lengths
        idx = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        valid = idx >= offsets[:, None]                          # (B, S)
        positions = torch.clamp(idx - offsets[:, None], min=0)   # (B, S)
    x = _embed(params, tokens)
    dt = _dtype(cfg)
    pol = cfg.dymoe
    e, k_tok = cfg.num_experts, cfg.num_experts_per_tok
    slots = cache_slots or max(s, cfg.max_seq_len)
    caches = init_kv_cache(b, cfg.num_kv_heads, slots, cfg.head_dim, dt,
                           dev, layers=cfg.num_layers)
    t_l = _t_l_array(cfg)
    vflat = valid.reshape(b * s) if valid is not None else None
    telem: Dict[str, list] = {}

    def record(**kw):
        for key, val in kw.items():
            telem.setdefault(key, []).append(val)

    for l in range(cfg.num_layers):
        lp = _index_tree(params["layers"], l)
        qm = _index_tree(qparams["layers"]["moe"], l)
        a, tok_imp, (k, v) = attention_train(
            lp["attn"], cfg, rmsnorm(lp["norm1"], x, cfg.norm_eps),
            positions=positions, kv_valid=valid, want_token_importance=True)
        fill_kv_cache(caches.index(l), k, v, lengths=lengths,
                      offsets=offsets)
        x = x + a
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        hflat = h.reshape(b * s, -1)
        if valid is None:
            hh = heavy_hitter_mask(tok_imp, pol.heavy_hitter_frac
                                   ).reshape(b * s)
        else:
            hh = _ragged_hh_mask(tok_imp, pol.heavy_hitter_frac, lengths,
                                 valid).reshape(b * s)
        # router pre-pass: pick the Critical set BEFORE expert compute
        # (Eq. 1-2 -> Eq. 5); ties broken by lower index
        probs_r = torch.softmax(hflat.to(torch.float32)
                                @ lp["moe"]["wg_router"], dim=-1)
        _, idx_r = stable_topk(probs_r, k_tok)
        oh = torch.nn.functional.one_hot(idx_r, e).to(torch.float32)
        if vflat is not None:                    # pads route nowhere
            oh = oh * vflat.to(torch.float32)[:, None, None]
        if row_local:
            oh_r = oh.reshape(b, s, k_tok, e)
            load_rows = oh_r.sum(dim=(1, 2))                     # (B, E)
            imp_rows = prefill_expert_importance_rows(
                torch.einsum("bske,bs->be", oh_r, hh.reshape(b, s)),
                load_rows)
            critical = select_critical_rows(imp_rows, t_l[l])
            y, st = moe_apply_prefill_rows(
                lp["moe"], cfg, hflat, critical, qm, rows=b, hh_mask=hh,
                token_valid=vflat, row_capacities=row_capacities)
            active, load, hh_load, gate_mean = (
                st["active"], load_rows, st["hh_load"], st["gate_mean"])
            aux, dropped = st["aux_loss"], st["dropped_frac"]
        else:
            imp = prefill_expert_importance(
                torch.einsum("tke,t->e", oh, hh), oh.sum(dim=(0, 1)))
            critical = select_critical(imp, t_l[l])
            y, st = moe_apply(lp["moe"], cfg, hflat, critical_mask=critical,
                              qweights=qm, hh_mask=hh, token_valid=vflat)
            active, load, hh_load, gate_mean = (
                st.expert_load > 0, st.expert_load, st.expert_hh_load,
                st.gate_mean)
            aux, dropped = st.aux_loss, st.dropped_frac
        x = x + y.reshape(b, s, -1)
        # look-ahead (Eq. 6-7) for the next layer's prefetcher
        pg = predict_next_gates(hflat, _next_router(params, cfg, l))
        if row_local:   # per-row Eq. 7: each admission's own demand
            _, freq = prefetch_targets(pg.reshape(b, s, e), k_tok,
                                       pol.prefetch_topk, token_valid=valid)
        else:
            _, freq = prefetch_targets(pg, k_tok, pol.prefetch_topk,
                                       token_valid=vflat)
        record(critical=critical, active=active, load=load, hh_load=hh_load,
               gate_mean=gate_mean, pred=freq, aux=aux, dropped=dropped,
               tok_imp=tok_imp)

    logits = _lm_head(params, cfg, rmsnorm(params["final_norm"], x[:, -1],
                                           cfg.norm_eps))
    st = {key: torch.stack(vals) for key, vals in telem.items()}
    st["pred"][-1] = 0.0     # layer 0's router fed the last layer: mask
    info = DyMoEInfo(critical_masks=st["critical"],
                     active_masks=st["active"], expert_load=st["load"],
                     expert_hh_load=st["hh_load"],
                     gate_mean=st["gate_mean"], predicted_next=st["pred"],
                     aux_loss=st["aux"].sum(),
                     dropped_frac=st["dropped"].to(torch.float32).mean(),
                     token_importance=st["tok_imp"][-1])
    return logits, {"layers": caches}, info


# ------------------------------------------------------------------- decode


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Dict[str, KVCache]:
    """Fresh stacked caches sized for ``seq_len`` context (``device``
    None means CUDA)."""
    _check_supported(cfg)
    device = resolve_device(device)
    return {"layers": init_kv_cache(batch, cfg.num_kv_heads, seq_len,
                                    cfg.head_dim, _dtype(cfg), device,
                                    layers=cfg.num_layers)}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, KVCache], *, qparams: dict,
                live_rows: Optional[torch.Tensor] = None,
                moe_capacity: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Dict[str, KVCache], DyMoEInfo]:
    """One continuous-batching decode step (the JAX package's
    ``per_row_moe=True``): every row picks its own gate-guided Critical
    set (Eq. 3) and experts run through the fused :func:`moe_apply_rows`.
    tokens: (B,) int. ``live_rows`` (B,) bool: dead rows take no MoE slot
    and their KV writes freeze; their logits are garbage by contract.
    ``moe_capacity`` (requires ``live_rows``) bounds each MoE precision
    region. Returns (logits (B, V) f32, caches (updated in place),
    DyMoEInfo with (L, B, E) leaves)."""
    _check_supported(cfg)
    b = tokens.shape[0]
    pol = cfg.dymoe
    t_l = _t_l_array(cfg)
    x = _embed(params, tokens[:, None])                         # (B, 1, dm)
    crit_l, act_l, gm_l, pred_l = [], [], [], []
    for l in range(cfg.num_layers):
        lp = _index_tree(params["layers"], l)
        a, _ = attention_decode(lp["attn"], cfg,
                                rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                caches["layers"].index(l), live=live_rows)
        x = x + a
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        hflat = h.reshape(b, -1)
        # Eq. (3) per row: each request's Critical set from ITS OWN gates
        imp = torch.softmax(hflat.to(torch.float32)
                            @ lp["moe"]["wg_router"], dim=-1)    # (B, E)
        critical = select_critical_rows(imp, t_l[l])
        y, rstats = moe_apply_rows(
            lp["moe"], cfg, hflat, critical,
            _index_tree(qparams["layers"]["moe"], l), live=live_rows,
            capacity=moe_capacity)
        x = x + y.reshape(b, 1, -1)
        pg = predict_next_gates(hflat, _next_router(params, cfg, l))
        _, freq = prefetch_targets(pg[:, None, :], cfg.num_experts_per_tok,
                                   pol.prefetch_topk)            # (B, E)
        crit_l.append(critical)
        act_l.append(rstats["active"])
        gm_l.append(rstats["gate_mean"])
        pred_l.append(freq)
    logits = _lm_head(params, cfg,
                      rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0])
    pred = torch.stack(pred_l)
    pred[-1] = 0.0
    return logits, caches, DyMoEInfo(
        critical_masks=torch.stack(crit_l), active_masks=torch.stack(act_l),
        gate_mean=torch.stack(gm_l), predicted_next=pred)


def _mask_info_rows(info: DyMoEInfo, live: torch.Tensor) -> DyMoEInfo:
    """Zero finished rows' telemetry (leaves (L, B, E), live (B,))."""
    m = live[None, :, None]
    return DyMoEInfo(critical_masks=info.critical_masks & m,
                     active_masks=info.active_masks & m,
                     gate_mean=info.gate_mean * m,
                     predicted_next=info.predicted_next * m)


def decode_many_batched(params, cfg: ModelConfig, tokens: torch.Tensor,
                        caches: Dict[str, KVCache], *, num_steps: int,
                        done: torch.Tensor, n_emitted: torch.Tensor,
                        limits: torch.Tensor, eos_tokens: torch.Tensor,
                        qparams: dict, live_cap: Optional[int] = None,
                        rng_keys: Optional[torch.Tensor] = None,
                        temperatures: Optional[torch.Tensor] = None,
                        top_ks: Optional[torch.Tensor] = None,
                        ) -> Tuple[torch.Tensor, Dict[str, KVCache],
                                   DyMoEInfo, torch.Tensor, torch.Tensor]:
    """Multi-step decode over a slot batch with a per-row done-mask — the
    device half of the continuous-batching scheduler.

    A row freezes once it emits its ``eos_tokens`` entry (-1 = none) or
    its ``n_emitted`` count reaches ``limits``: its token re-feeds
    unchanged, its KV writes freeze at the write site (so the JAX
    package's whole-cache freeze has nothing left to do), and its
    telemetry is zeroed. Nothing here reads a device value on the host:
    the caller syncs once, at the chunk boundary. ``live_cap`` caps each
    MoE precision region at that many rows (a power of two >= the live
    count, from the scheduler's ladder).

    Sampling is greedy unless ``rng_keys`` (B, 2) raw per-row PRNG keys,
    ``temperatures`` (B,) and ``top_ks`` (B,) are given: row r's step then
    draws with ``fold_in(rng_keys[r], n_emitted[r])``, its own emitted
    count, through :func:`repro_torch.serving.sampler.sample_token_rows`,
    so its tokens equal a solo run's and do not depend on the chunk
    length or the slot. Rows with ``temperature <= 0`` take the argmax.

    tokens/done/n_emitted/limits/eos_tokens: (B,). Returns (tokens
    (num_steps, B) int32, caches (updated in place), DyMoEInfo with
    leaves (num_steps, L, B, E), done (B,), n_emitted (B,))."""
    # local import: serving depends on models, not the reverse
    from repro_torch.serving.sampler import fold_in, sample_token_rows

    tok = tokens.to(torch.int32)
    dn = done.to(torch.bool)
    emitted = n_emitted.to(torch.int32)
    toks, infos = [], []
    for _ in range(num_steps):
        live = ~dn
        logits, caches, info = decode_step(
            params, cfg, tok, caches, qparams=qparams, live_rows=live,
            moe_capacity=live_cap)
        if rng_keys is None:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)  # first max
        else:
            nxt = sample_token_rows(logits, fold_in(rng_keys, emitted),
                                    temperatures, top_ks)
        nxt = torch.where(dn, tok, nxt)
        emitted = emitted + live.to(torch.int32)
        dn = dn | ((eos_tokens >= 0) & (nxt == eos_tokens)) \
            | (emitted >= limits)
        toks.append(nxt)
        infos.append(_mask_info_rows(info, live))
        tok = nxt
    stacked = DyMoEInfo(**{
        f: torch.stack([getattr(i, f) for i in infos])
        for f in ("critical_masks", "active_masks", "gate_mean",
                  "predicted_next")})
    return torch.stack(toks), caches, stacked, dn, emitted
