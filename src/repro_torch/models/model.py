"""Top-level model of the port: init, quantization, the training forward
and loss, prefill and the continuous-batching decode for every block kind
of the JAX package (torch twin of ``repro/models/model.py``), under DyMoE
mixed precision on the inference paths.

Per-layer parameters are STACKED with a leading L dim, as in the JAX
package; a Python loop over the layers takes the place of ``lax.scan``.
Layer pattern per family (pre-norm residual blocks):
  dense/vlm/audio:  x += Attn(n1(x));  x += MLP(n2(x))
  moe:              x += Attn(n1(x));  x += MoE(n2(x))      [+ shared experts]
  ssm:              x += Mamba(n1(x))
  hybrid (zamba2):  the Mamba backbone, with a weight-SHARED attention
                    block run BEFORE layer l's Mamba block wherever
                    ``l % shared_attn_every == 0`` (one KV cache per site).

DyMoE runs when ``qparams`` is given and ``cfg.dymoe.enabled`` (the
reference's ``dymoe_on``); otherwise every block runs its float weights —
the MoE experts through ``moe_apply``'s full-precision SwiGLU, the dense
FFN through ``mlp``, the Mamba projections as dense products — and the
MoE telemetry reports every expert Critical.

DyMoE on the inference paths:
  * MoE prefill — attention yields the per-token received mass (Eq. 1);
    heavy-hitter routing stats give expert importance (Eq. 2); the depth
    schedule's t_l picks the Critical set (Eq. 4–5); next-layer gate
    predictions (Eq. 6–7) are emitted for the prefetcher. ``row_local``
    picks a Critical set per row (the batched admission wave).
  * MoE decode — gate-guided importance (Eq. 3) and direct prefetch (Eq.
    8): per row, with a live-row mask that freezes finished rows, for the
    continuous-batching chunk (``decode_many_batched``); from the
    batch-mean gate for the single-sequence reference (``decode_many``).
  * dense / SSM / hybrid — only the depth-aware layer tiering applies: a
    layer is Critical when its retention ratio reaches the schedule mean
    (``_layer_tier_flags``), and its FFN (or the Mamba in/out
    projections) runs from the packed codes of that tier's precision. No
    telemetry leaves: the replay prices them by the cost model alone.

Every MoE site with one Critical mask (or none) goes through
``moe_apply_sharded``: with ``cfg.moe_dispatch_shards`` D > 1 dividing the
token count, D token groups of their own capacity, folded into one
buffer (still three K2 launches). ``cfg.act_seq_shard`` is a sharding
constraint on the residual stream in the JAX package, numerically the
identity: on one device it changes nothing here.

Caches are written in place (see ``kv_cache.py`` and ``layers/ssm.py``):
{"layers": KVCache or SSMCache with a leading L, "shared": KVCache with a
leading n_sites (hybrid only)}.

``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) runs the inference
paths as one program on every rank of the mesh, over params and stores
that ``sharding/partition.py`` split (``Shard`` leaves) and KV caches whose
slots are split over "model" (``sharding/spmd.py`` places the
collectives). This slice covers MoE and dense attention models on meshes
whose every axis but "model" is 1; SSM and hybrid blocks, a data axis
above 1 and ``cfg.moe_dispatch_axes`` raise under a mesh.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.importance import heavy_hitter_mask, \
    prefill_expert_importance, prefill_expert_importance_rows, \
    select_critical, select_critical_rows, stable_topk
from repro_torch.core.prefetch import predict_next_gates, prefetch_targets
from repro_torch.core.schedule import critical_counts, retention_ratio
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import KVCache, fill_kv_cache, init_kv_cache
from repro_torch.models.layers.attention import attention_decode, \
    attention_train
from repro_torch.models.layers.mlp import init_mlp, mlp, mlp_quantized
from repro_torch.models.layers.moe import moe_apply_prefill_rows, \
    moe_apply_rows, moe_apply_sharded
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rotary import sinusoidal_embedding
from repro_torch.models.layers.ssm import init_mamba, init_ssm_cache, \
    mamba_decode, mamba_prefill
from repro_torch.quant.qtensor import MixedPrecisionWeights
from repro_torch.sharding import spmd
from repro_torch.tree import tree_map

__all__ = ["init_params", "init_sharded", "quantize_model", "forward",
           "loss_fn",
           "train_step_fn", "prefill", "decode_step", "decode_many",
           "decode_many_batched", "init_decode_state", "DyMoEInfo"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _index_tree(tree, i):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, MixedPrecisionWeights):
        return tree.index(i)
    return tree[i]


# --------------------------------------------------------------------- init


class _Draw:
    """Seeded draws of ``init_params`` on one device: a stacked tensor is
    drawn layer by layer, so no full-depth f32 temporary is built."""

    def __init__(self, generator: torch.Generator, device, dtype):
        self.gen, self.device, self.dtype = generator, device, dtype

    def _fill(self, shape, dtype, sample):
        out = torch.empty(shape, dtype=dtype or self.dtype,
                          device=self.device)
        for dst in (out if len(shape) > 2 else [out]):
            dst.copy_(sample(dst.shape))
        return out

    def normal(self, shape, scale, dtype=None):
        """N(0, scale²) draws; tensors of more than 2 dims are stacked."""
        return self._fill(shape, dtype, lambda sh: torch.randn(
            sh, generator=self.gen, device=self.device) * scale)

    def uniform(self, shape, lo, hi):
        """f32 draws uniform in [lo, hi)."""
        return self._fill(shape, torch.float32, lambda sh: torch.rand(
            sh, generator=self.gen, device=self.device) * (hi - lo) + lo)

    def full(self, shape, value, dtype=None):
        return torch.full(shape, value, dtype=dtype or self.dtype,
                          device=self.device)


def _init_attention(cfg: ModelConfig, draw: _Draw, lead=()) -> dict:
    dm, h, hk, d = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    attn = {"wq": draw.normal(lead + (dm, h * d), dm ** -0.5),
            "wk": draw.normal(lead + (dm, hk * d), dm ** -0.5),
            "wv": draw.normal(lead + (dm, hk * d), dm ** -0.5),
            "wo": draw.normal(lead + (h * d, dm), (h * d) ** -0.5)}
    if cfg.qkv_bias:
        for n, w in (("bq", h * d), ("bk", hk * d), ("bv", hk * d)):
            attn[n] = draw.full(lead + (w,), 0.0)
    if cfg.qk_norm:
        attn["q_norm"] = {"scale": draw.full(lead + (d,), 1.0)}
        attn["k_norm"] = {"scale": draw.full(lead + (d,), 1.0)}
    return attn


def _init_moe(cfg: ModelConfig, draw: _Draw, lead) -> dict:
    dm, e, dff = cfg.d_model, cfg.num_experts, cfg.expert_d_ff
    moe = {"wg_router": draw.normal(lead + (dm, e), dm ** -0.5,
                                    torch.float32),
           "w_gate": draw.normal(lead + (e, dm, dff), dm ** -0.5),
           "w_up": draw.normal(lead + (e, dm, dff), dm ** -0.5),
           "w_down": draw.normal(lead + (e, dff, dm), dff ** -0.5)}
    if cfg.num_shared_experts:
        se = cfg.num_shared_experts
        moe["shared_w_gate"] = draw.normal(lead + (se, dm, dff), dm ** -0.5)
        moe["shared_w_up"] = draw.normal(lead + (se, dm, dff), dm ** -0.5)
        moe["shared_w_down"] = draw.normal(lead + (se, dff, dm),
                                           dff ** -0.5)
    return moe


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (on ``device``; ``None`` takes
    the generator's device), stacked along a leading L dim with the JAX
    package's tree layout and init scales. (Torch RNG cannot reproduce
    ``jax.random``: tests bring JAX-made parameters across with
    ``repro_torch.params``.)"""
    cfg.validate()
    device = resolve_device(generator.device if device is None else device)
    return _init_tree(cfg, _Draw(generator, device, _dtype(cfg)))


def _init_tree(cfg: ModelConfig, draw: _Draw) -> Dict[str, Any]:
    """The params tree of :func:`init_params`, leaves from ``draw``."""
    L, dm, V = cfg.num_layers, cfg.d_model, cfg.vocab_size
    kind = cfg.block_kinds()[0]
    lead = (L,)
    layers: Dict[str, Any] = {"norm1": {"scale": draw.full((L, dm), 1.0)}}
    if kind == "ssm":
        layers["ssm"] = init_mamba(cfg, draw, lead)
    else:
        layers["norm2"] = {"scale": draw.full((L, dm), 1.0)}
        layers["attn"] = _init_attention(cfg, draw, lead)
        if kind == "attn_moe":
            layers["moe"] = _init_moe(cfg, draw, lead)
        else:
            layers["mlp"] = init_mlp(cfg, draw, lead)
    params = {"embed": draw.normal((V, dm), dm ** -0.5),
              "final_norm": {"scale": draw.full((dm,), 1.0)},
              "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw.normal((dm, V), dm ** -0.5)
    if cfg.shared_attn_every:
        params["shared_attn"] = {
            "norm1": {"scale": draw.full((dm,), 1.0)},
            "norm2": {"scale": draw.full((dm,), 1.0)},
            "attn": _init_attention(cfg, draw),
            "mlp": init_mlp(cfg, draw)}
    return params


def quantize_model(params, cfg: ModelConfig) -> Dict[str, Any]:
    """DyMoE mixed-precision store (paper §5: the routed experts; on
    non-MoE archs the FFN or the SSM in/out projections, the closest
    analogue), with the leading L dim kept. Quantized LAYER BY LAYER on the
    weights' device: the full-depth f32 temporary of an OLMoE expert matrix
    would be 8.6 GB."""
    kind, pol = cfg.block_kinds()[0], cfg.dymoe
    if kind == "attn_moe":
        group, names = "moe", ("w_gate", "w_up", "w_down")
    elif kind == "attn_dense":
        group, names = "mlp", tuple(params["layers"]["mlp"])
    else:
        group, names = "ssm", ("in_proj", "out_proj")
    out = {}
    for name in names:
        w = params["layers"][group][name]
        stacked: Optional[MixedPrecisionWeights] = None
        for l in range(w.shape[0]):
            mp = MixedPrecisionWeights.build(w[l], pol.high_bits,
                                             pol.low_bits or None,
                                             pol.group_size)
            if stacked is None:
                stacked = _alloc_stacked(mp, w.shape[0])
            _copy_layer(stacked, mp, l)
        out[name] = stacked
    return {"layers": {group: out}}


class _Lazy:
    """A leaf ``init_params`` asked for, not drawn yet: its shape, dtype
    and draw (see :func:`init_sharded`)."""

    def __init__(self, shape, dtype, sample):
        self.shape, self.dtype, self.sample = tuple(shape), dtype, sample


class _LazyDraw(_Draw):
    """``init_params``' draws recorded in call order instead of made."""

    def __init__(self, generator, device, dtype):
        super().__init__(generator, device, dtype)
        self.order: List[_Lazy] = []

    def _fill(self, shape, dtype, sample):
        self.order.append(_Lazy(shape, dtype or self.dtype, sample))
        return self.order[-1]


def init_sharded(cfg: ModelConfig, generator: torch.Generator, mesh, *,
                 expert_parallel: bool = False, device=None,
                 quantize: bool = True):
    """This rank's shards of ``init_params(cfg, generator, device)`` and,
    with ``quantize``, of ``quantize_model`` of them — equal to what
    ``shard_tree`` keeps of the whole trees under ``param_shardings``
    (``expert_parallel`` as there) — without building either whole: the
    leaves are drawn in ``init_params``' order and a stacked one a layer
    at a time, as it draws them; a rank keeps its block of each layer and
    quantizes each layer of the DyMoE store's weights whole before it
    keeps its block. Returns (params, qparams or None). Attention
    architectures only, as every mesh of this slice."""
    from repro_torch.sharding.partition import Shard, _block, _spec_for, \
        _split_dim, param_shardings, shard_tree, tree_specs

    _check_mesh(cfg, mesh)
    cfg.validate()
    device = resolve_device(generator.device if device is None else device)
    draw = _LazyDraw(generator, device, _dtype(cfg))
    lazy = _init_tree(cfg, draw)
    paths = {}
    tree_specs(lazy, lambda path, leaf: paths.setdefault(id(leaf), path))
    pol = cfg.dymoe
    group = "moe" if cfg.block_kinds()[0] == "attn_moe" else "mlp"
    stacks: Dict[Any, Any] = {}

    def keep(key, path: str, t: torch.Tensor, l: int, n: int) -> None:
        """Layer ``l`` of the n-layer leaf at ``path``: this rank's block
        of ``t``, into its stack."""
        d = _split_dim(_spec_for(path, (n,) + tuple(t.shape), mesh,
                                 expert_parallel), mesh)
        blk = t if d is None else _block(t, d - 1, mesh)
        if key not in stacks:
            buf = blk.new_empty((n,) + tuple(blk.shape))
            stacks[key] = buf if d is None else Shard(buf, d, mesh)
        stack = stacks[key]
        (stack.local if isinstance(stack, Shard) else stack)[l].copy_(blk)

    made, qmade = {}, {}
    for leaf in draw.order:
        path = paths[id(leaf)]
        if len(leaf.shape) <= 2:   # drawn whole, split by shard_tree below
            made[id(leaf)] = leaf.sample(leaf.shape).to(leaf.dtype)
            continue
        n = leaf.shape[0]
        name = path.rsplit("/", 1)[1]
        quantized = quantize and path == f"/layers/{group}/{name}" \
            and name.startswith("w_")
        for l in range(n):
            t = leaf.sample(leaf.shape[1:]).to(leaf.dtype)
            keep(id(leaf), path, t, l, n)
            if quantized:
                mp = MixedPrecisionWeights.build(t, pol.high_bits,
                                                 pol.low_bits or None,
                                                 pol.group_size)
                for prec, qt in (("high", mp.high), ("low", mp.low)):
                    for f in ("packed", "scales") if qt else ():
                        keep((name, prec, f), f"{path}/{prec}.{f}",
                             getattr(qt, f), l, n)
        made[id(leaf)] = stacks.pop(id(leaf))
        if quantized:
            qmade[name] = MixedPrecisionWeights(*(
                None if qt is None else dataclasses.replace(
                    qt, packed=stacks.pop((name, prec, "packed")),
                    scales=stacks.pop((name, prec, "scales")))
                for prec, qt in (("high", mp.high), ("low", mp.low))))

    # (the leaves init_params filled outright, norms and biases, are real)
    params = tree_specs(lazy, lambda path, leaf: made.get(id(leaf), leaf))
    params = shard_tree(params, param_shardings(
        params, mesh, expert_parallel=expert_parallel), mesh)
    qparams = None
    if quantize:
        qparams = {"layers": {group: {
            n: qmade[n] for n in lazy["layers"][group] if n in qmade}}}
    return params, qparams


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


def _embed(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
           embeds: Optional[torch.Tensor] = None,
           positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, or ``embeds`` (B, S, dm) from a VLM / audio
    frontend; sinusoidal positions added where the config uses them, from
    ``positions`` (B, S) (each row's own offsets in a ragged batch)."""
    x = (embeds.to(_dtype(cfg)) if embeds is not None
         else spmd.embed(params["embed"], tokens))
    if cfg.pos_emb == "sinusoidal":
        b, s, dm = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device)[None].expand(b, s)
        x = x + sinusoidal_embedding(positions, dm).to(x.dtype)
    return x


def _lm_head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return spmd.lm_head(x, w, cfg.tie_embeddings).to(torch.float32)


def _check_mesh(cfg: ModelConfig, mesh) -> None:
    """What this slice runs under a mesh (see the module docstring)."""
    if mesh is None or mesh.size == 1:
        return
    nxt = "the next slice of the port (ROADMAP.md)"
    if cfg.block_kinds()[0] not in ("attn_dense", "attn_moe") \
            or cfg.shared_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: SSM and hybrid blocks under a mesh are {nxt}")
    if mesh.size != mesh.model_size:
        raise NotImplementedError(
            f"a {mesh.shape} mesh: a data or pod axis above 1 is {nxt}")
    if cfg.moe_dispatch_axes:
        raise NotImplementedError(
            f"moe_dispatch_axes={cfg.moe_dispatch_axes} under a mesh is "
            f"{nxt}")


def _kv_split(mesh, slots: int) -> dict:
    """``init_kv_cache``'s ``shards`` / ``shard`` for ``slots`` over
    ``mesh``: split over "model" when it divides them (the guard of
    ``cache_shardings``), else whole on every rank."""
    if mesh is None or mesh.model_size == 1 or slots % mesh.model_size:
        return {}
    return dict(shards=mesh.model_size, shard=mesh.model_rank)


def _t_l_array(cfg: ModelConfig) -> List[int]:
    return list(critical_counts(cfg.num_layers, max(cfg.num_experts, 1),
                                cfg.dymoe.lam, cfg.dymoe.depth_schedule))


def _layer_tier_flags(cfg: ModelConfig) -> List[bool]:
    """Depth-aware layer criticality for non-MoE archs, on the host: a
    layer is Critical (high precision) when its retention ratio is >= the
    schedule mean (Python floats, as the JAX package compares them)."""
    lam = cfg.dymoe.lam
    mean_r = (1.0 + lam) / 2.0
    return [retention_ratio(l, cfg.num_layers, lam,
                            cfg.dymoe.depth_schedule) >= mean_r
            for l in range(cfg.num_layers)]


def _shared_flags(cfg: ModelConfig) -> List[bool]:
    """Whether the hybrid's shared attention block runs before layer l."""
    return [bool(cfg.shared_attn_every) and l % cfg.shared_attn_every == 0
            for l in range(cfg.num_layers)]


def _site_index(cfg: ModelConfig) -> List[int]:
    """Per-layer index into the shared-site cache stack (valid where the
    shared flag is set)."""
    idx, cur = [], 0
    for l, shared in enumerate(_shared_flags(cfg)):
        idx.append(cur)
        cur += shared
    return idx


def _n_sites(cfg: ModelConfig) -> int:
    return sum(_shared_flags(cfg))


def _q_ssm(sp: dict, qs: dict, tier: bool) -> dict:
    """Swap the SSM projections for ``(MixedPrecisionWeights, tier)`` pairs:
    ssm.py's ``_proj`` runs them from the packed codes of the tier's
    precision."""
    return dict(sp, in_proj=(qs["in_proj"], tier),
                out_proj=(qs["out_proj"], tier))


def _ffn(lp: dict, q: Optional[dict], cfg: ModelConfig, l: int, tier: bool,
         h: torch.Tensor) -> torch.Tensor:
    """A dense layer's FFN: from the packed codes of its tier with DyMoE
    on (``q`` the quantized layer stack), else the float ``mlp``."""
    if q is None:
        return mlp(lp["mlp"], cfg, h)
    return mlp_quantized(_index_tree(q["mlp"], l), cfg, h, tier)


def _ssm_params(lp: dict, q: Optional[dict], l: int, tier: bool) -> dict:
    """A Mamba layer's parameters: its projections from the packed codes
    of its tier with DyMoE on, else the float ones."""
    if q is None:
        return lp["ssm"]
    return _q_ssm(lp["ssm"], _index_tree(q["ssm"], l), tier)


def _shared_block_train(params, cfg: ModelConfig, x: torch.Tensor):
    """The hybrid's weight-shared attention + (unquantized) MLP block over
    a whole prompt; returns (x, (k, v))."""
    sp = params["shared_attn"]
    a, _, kv = attention_train(sp["attn"], cfg,
                               rmsnorm(sp["norm1"], x, cfg.norm_eps))
    x = x + a
    x = x + mlp(sp["mlp"], cfg, rmsnorm(sp["norm2"], x, cfg.norm_eps))
    return x, kv


def _shared_block_decode(params, cfg: ModelConfig, x: torch.Tensor,
                         cache: KVCache, live: Optional[torch.Tensor]):
    sp = params["shared_attn"]
    a, _ = attention_decode(sp["attn"], cfg,
                            rmsnorm(sp["norm1"], x, cfg.norm_eps), cache,
                            live=live)
    x = x + a
    return x + mlp(sp["mlp"], cfg, rmsnorm(sp["norm2"], x, cfg.norm_eps))


# ------------------------------------------------------- train forward


def _unbind_layers(tree, n: int) -> List[dict]:
    """The n per-layer trees of a stacked parameter tree, through one
    ``unbind`` a leaf: its backward stacks every layer's grad at once,
    where indexing a layer would add a zero gradient of the full stack
    for each layer."""
    if isinstance(tree, dict):
        parts = {k: _unbind_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][l] for k in tree} for l in range(n)]
    return list(torch.unbind(tree, 0))


def _train_block(params, cfg: ModelConfig, kind: str, shared: bool,
                 lp: dict, x: torch.Tensor, aux: torch.Tensor):
    """One layer of :func:`forward` (the hybrid's shared block first
    where it runs); returns (x, aux)."""
    if shared:
        x = _shared_block_train(params, cfg, x)[0]
    if kind == "ssm":
        # a fresh zero state a call, as the reference's init_ssm_cache
        y, _ = mamba_prefill(lp["ssm"], cfg,
                             rmsnorm(lp["norm1"], x, cfg.norm_eps), None)
        return x + y, aux
    a, _, _ = attention_train(lp["attn"], cfg,
                              rmsnorm(lp["norm1"], x, cfg.norm_eps))
    x = x + a
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if kind == "attn_dense":
        return x + mlp(lp["mlp"], cfg, h), aux
    b, s, _ = h.shape
    y, stats = moe_apply_sharded(lp["moe"], cfg, h.reshape(b * s, -1))
    return x + y.reshape(b, s, -1), aux + stats.aux_loss


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            *, embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. Returns (logits (B,S,V) f32, aux_loss scalar: the
    MoE router losses summed over the layers). ``cfg.remat == "block"``
    recomputes each block in the backward pass (``jax.checkpoint``'s
    counterpart, non-reentrant activation checkpointing)."""
    x = _embed(params, cfg, tokens, embeds)
    kind = cfg.block_kinds()[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = _unbind_layers(params["layers"], cfg.num_layers)
    for lp, shared in zip(layers, _shared_flags(cfg)):
        if cfg.remat == "block":
            x, aux = checkpoint(_train_block, params, cfg, kind, shared, lp,
                                x, aux, use_reentrant=False)
        else:
            x, aux = _train_block(params, cfg, kind, shared, lp, x, aux)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked mean next-token NLL plus the router losses; returns (loss,
    {"ce", "aux"}). ``batch``: "tokens" (or "embeds"), "labels", and an
    optional "loss_mask"."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"))
    labels = batch["labels"].to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def train_step_fn(cfg: ModelConfig, optimizer):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "aux"})``: the grads of :func:`loss_fn` over every
    param leaf by ``torch.autograd.grad``, then ``optimizer.update``. The
    params given are not modified."""

    def step(params, opt_state, batch):
        leaves: List[torch.Tensor] = []

        def track(p):
            leaves.append(p.detach().requires_grad_(True))
            return leaves[-1]

        with torch.enable_grad():
            loss, metrics = loss_fn(tree_map(track, params), cfg, batch)
            found = iter(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))

        def grad_of(p):
            # a leaf the loss does not reach: the zero grad jax.grad gives
            g = next(found)
            return torch.zeros_like(p) if g is None else g

        grads = tree_map(grad_of, params)
        params, opt_state = optimizer.update(params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach())

    return step


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


def prefill(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            *, embeds: Optional[torch.Tensor] = None,
            qparams: Optional[dict] = None,
            cache_slots: Optional[int] = None,
            lengths: Optional[torch.Tensor] = None,
            row_local: bool = False,
            row_capacities: Optional[torch.Tensor] = None,
            mesh=None,
            ) -> Tuple[torch.Tensor, Dict[str, Any], DyMoEInfo]:
    """Prefill, under DyMoE mixed precision when ``qparams`` is given and
    the policy is enabled (else at full precision). tokens: (B, S) int, or
    ``embeds`` (B, S, dm) from a VLM / audio frontend.

    ``lengths`` (B,) enables RAGGED batches (attention archs without a
    shared-attention site): ``tokens`` is right-aligned (row i left-padded
    with ``S - lengths[i]`` pads), per-row position offsets drive RoPE and
    sinusoidal embeddings, attention masks pad keys, routing statistics
    exclude pads, and the KV cache records each row's slot offset. An SSM
    scan would thread pads through its state, so SSM archs prefill solo.

    ``row_local`` (MoE; the batched admission wave): each row's Critical
    set is picked from its own Eq. 1–2 importance and experts run through
    the dual-buffer :func:`moe_apply_prefill_rows`, so a row never depends
    on its neighbours; MoE telemetry comes back (L, B, E).
    ``row_capacities`` (B,) pins each row's capacity to the host
    ``_capacity`` value. A no-op for non-MoE archs, whose rows are
    independent already. ``mesh``: run as one rank of it (module
    docstring); the caches' slots are split over "model" where it divides
    them.

    Returns (last-token logits (B, V) f32, caches {"layers": stacked
    KVCache or SSMCache, "shared": the hybrid's per-site KVCache stack},
    DyMoEInfo — its leaves None for non-MoE archs)."""
    _check_mesh(cfg, mesh)
    kind = cfg.block_kinds()[0]
    hybrid = bool(cfg.shared_attn_every)
    src = tokens if tokens is not None else embeds
    b, s = src.shape[:2]
    dev = src.device
    offsets = valid = positions = None
    if lengths is not None:
        assert kind in ("attn_dense", "attn_moe") and not hybrid, \
            "ragged prefill requires attention archs without shared sites"
        lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        offsets = torch.full((b,), s, dtype=torch.int32, device=dev) - lengths
        idx = torch.arange(s, dtype=torch.int32, device=dev)[None, :]
        valid = idx >= offsets[:, None]                          # (B, S)
        positions = torch.clamp(idx - offsets[:, None], min=0)   # (B, S)
    x = _embed(params, cfg, tokens, embeds, positions)
    dt = _dtype(cfg)
    slots = cache_slots or (cfg.sliding_window or max(s, cfg.max_seq_len))
    ring = cfg.sliding_window is not None and slots == cfg.sliding_window
    assert lengths is None or not ring, \
        "ragged prefill unsupported with sliding-window ring caches"
    if kind == "ssm":
        caches = {"layers": init_ssm_cache(cfg, b, dt, dev,
                                           layers=cfg.num_layers)}
    else:
        caches = {"layers": init_kv_cache(b, cfg.num_kv_heads, slots,
                                          cfg.head_dim, dt, dev,
                                          layers=cfg.num_layers, ring=ring,
                                          **_kv_split(mesh, slots))}
    if hybrid:
        caches["shared"] = init_kv_cache(b, cfg.num_kv_heads, slots,
                                         cfg.head_dim, dt, dev,
                                         layers=_n_sites(cfg), ring=ring)
    dymoe_on = qparams is not None and cfg.dymoe.enabled
    if kind == "attn_moe":
        x, info = _prefill_moe(params, cfg, x, caches["layers"],
                               qparams if dymoe_on else None,
                               lengths=lengths, offsets=offsets, valid=valid,
                               positions=positions, row_local=row_local,
                               row_capacities=row_capacities)
    else:
        tier, shared = _layer_tier_flags(cfg), _shared_flags(cfg)
        site = _site_index(cfg)
        q = qparams["layers"] if dymoe_on else None
        for l in range(cfg.num_layers):
            lp = _index_tree(params["layers"], l)
            if shared[l]:
                x, (k_s, v_s) = _shared_block_train(params, cfg, x)
                fill_kv_cache(caches["shared"].index(site[l]), k_s, v_s)
            if kind == "attn_dense":
                a, _, (k, v) = attention_train(
                    lp["attn"], cfg, rmsnorm(lp["norm1"], x, cfg.norm_eps),
                    positions=positions, kv_valid=valid)
                fill_kv_cache(caches["layers"].index(l), k, v,
                              lengths=lengths, offsets=offsets)
                x = x + a
                x = x + _ffn(lp, q, cfg, l, tier[l],
                             rmsnorm(lp["norm2"], x, cfg.norm_eps))
            else:
                y, _ = mamba_prefill(_ssm_params(lp, q, l, tier[l]), cfg,
                                     rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                     caches["layers"].index(l))
                x = x + y
        info = DyMoEInfo()
    logits = _lm_head(params, cfg, rmsnorm(params["final_norm"], x[:, -1],
                                           cfg.norm_eps))
    return logits, caches, info


def _prefill_moe(params, cfg: ModelConfig, x: torch.Tensor, caches: KVCache,
                 qparams: dict, *, lengths, offsets, valid, positions,
                 row_local: bool, row_capacities):
    """The MoE layer stack of :func:`prefill`; returns (x, DyMoEInfo).
    ``qparams`` None runs the experts at full precision, as the reference
    does with DyMoE off: every expert Critical, no heavy hitters."""
    dymoe_on = qparams is not None
    b, s = x.shape[:2]
    pol = cfg.dymoe
    e, k_tok = cfg.num_experts, cfg.num_experts_per_tok
    t_l = _t_l_array(cfg)
    vflat = valid.reshape(b * s) if valid is not None else None
    telem: Dict[str, list] = {}

    def record(**kw):
        for key, val in kw.items():
            telem.setdefault(key, []).append(val)

    for l in range(cfg.num_layers):
        lp = _index_tree(params["layers"], l)
        qm = _index_tree(qparams["layers"]["moe"], l) if dymoe_on else None
        a, tok_imp, (k, v) = attention_train(
            lp["attn"], cfg, rmsnorm(lp["norm1"], x, cfg.norm_eps),
            positions=positions, kv_valid=valid, want_token_importance=True)
        fill_kv_cache(caches.index(l), k, v, lengths=lengths,
                      offsets=offsets)
        x = x + a
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        hflat = h.reshape(b * s, -1)
        hh = None
        if dymoe_on:
            hh = (heavy_hitter_mask(tok_imp, pol.heavy_hitter_frac)
                  if valid is None else
                  _ragged_hh_mask(tok_imp, pol.heavy_hitter_frac, lengths,
                                  valid)).reshape(b * s)
        if dymoe_on or row_local:
            # router pre-pass: pick the Critical set BEFORE expert compute
            # (Eq. 1-2 -> Eq. 5); ties broken by lower index
            probs_r = torch.softmax(hflat.to(torch.float32)
                                    @ lp["moe"]["wg_router"], dim=-1)
            gates_r, idx_r = stable_topk(probs_r, k_tok)
            oh = torch.nn.functional.one_hot(idx_r, e).to(torch.float32)
            if vflat is not None:                    # pads route nowhere
                oh = oh * vflat.to(torch.float32)[:, None, None]
        if row_local and not dymoe_on:
            # full precision: the wave's experts run as one batch; only
            # the telemetry is per row
            oh_r = oh.reshape(b, s, k_tok, e)
            load_rows = oh_r.sum(dim=(1, 2))                     # (B, E)
            y, st = moe_apply_sharded(lp["moe"], cfg, hflat,
                                      token_valid=vflat)
            critical = torch.ones((b, e), dtype=torch.bool, device=x.device)
            active, load = load_rows > 0, load_rows
            hh_load = torch.zeros_like(load_rows)
            gn = gates_r / torch.clamp(gates_r.sum(-1, keepdim=True),
                                       min=1e-9)
            gate_mean = torch.einsum(
                "bske,bsk->be", oh_r, gn.reshape(b, s, k_tok)
            ) / torch.clamp(load_rows, min=1.0)
            aux, dropped = st.aux_loss, st.dropped_frac
        elif row_local:
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
            critical = None
            if dymoe_on:
                imp = prefill_expert_importance(
                    torch.einsum("tke,t->e", oh, hh), oh.sum(dim=(0, 1)))
                critical = select_critical(imp, t_l[l])
            y, st = moe_apply_sharded(lp["moe"], cfg, hflat,
                                      critical_mask=critical, qweights=qm,
                                      hh_mask=hh, token_valid=vflat)
            if critical is None:
                critical = torch.ones((e,), dtype=torch.bool,
                                      device=x.device)
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

    st = {key: torch.stack(vals) for key, vals in telem.items()}
    st["pred"][-1] = 0.0     # layer 0's router fed the last layer: mask
    return x, DyMoEInfo(critical_masks=st["critical"],
                        active_masks=st["active"], expert_load=st["load"],
                        expert_hh_load=st["hh_load"],
                        gate_mean=st["gate_mean"], predicted_next=st["pred"],
                        aux_loss=st["aux"].sum(),
                        dropped_frac=st["dropped"].to(torch.float32).mean(),
                        token_importance=st["tok_imp"][-1])


# ------------------------------------------------------------------- decode


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None, mesh=None) -> Dict[str, Any]:
    """Fresh stacked caches sized for ``seq_len`` context, ring-buffered
    to the sliding window when one is configured (``device`` None means
    CUDA); an SSM state does not depend on ``seq_len``, the hybrid's
    shared-site KV caches do. Under ``mesh`` a rank allocates only its
    block of the slots where "model" divides them (``cache_shardings``'
    layout)."""
    _check_mesh(cfg, mesh)
    device = resolve_device(device)
    dt = _dtype(cfg)
    slots = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len
    ring = cfg.sliding_window is not None and slots == cfg.sliding_window
    if cfg.block_kinds()[0] == "ssm":
        caches = {"layers": init_ssm_cache(cfg, batch, dt, device,
                                           layers=cfg.num_layers)}
    else:
        caches = {"layers": init_kv_cache(batch, cfg.num_kv_heads, slots,
                                          cfg.head_dim, dt, device,
                                          layers=cfg.num_layers, ring=ring,
                                          **_kv_split(mesh, slots))}
    if cfg.shared_attn_every:
        caches["shared"] = init_kv_cache(batch, cfg.num_kv_heads, slots,
                                         cfg.head_dim, dt, device,
                                         layers=_n_sites(cfg), ring=ring)
    return caches


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, Any], *, qparams: Optional[dict] = None,
                per_row_moe: bool = False,
                live_rows: Optional[torch.Tensor] = None,
                moe_capacity: Optional[int] = None, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any], DyMoEInfo]:
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    caches (updated in place), DyMoEInfo).

    ``per_row_moe=False`` (the single-sequence reference path): the
    gate-guided Critical set (Eq. 3) comes from the batch-mean gate and
    experts run through :func:`moe_apply_sharded` with that one mask —
    three K2 launches a layer through ``quant/mixed.py``; telemetry leaves
    are (L, E).

    ``per_row_moe=True`` (continuous batching): every row picks its own
    Critical set and experts run through the fused :func:`moe_apply_rows`
    (K1); leaves are (L, B, E). ``live_rows`` (B,) bool: dead rows take no
    MoE slot and their KV writes and SSM state freeze; their logits are
    garbage by contract. ``moe_capacity`` (requires ``live_rows``) bounds
    each MoE precision region. Non-MoE archs are row-independent either
    way: their FFN / SSM projections run K2 from the tier's packed codes,
    and their telemetry leaves are None. Without ``qparams``, or with the
    policy disabled, every block runs its float weights (see the module
    docstring). ``mesh``: run as one rank of it (module docstring)."""
    _check_mesh(cfg, mesh)
    if not per_row_moe and (live_rows is not None
                            or moe_capacity is not None):
        raise ValueError("live_rows / moe_capacity need per_row_moe=True")
    kind = cfg.block_kinds()[0]
    positions = caches["layers"].length[0][:, None]  # (B, 1) new token
    x = _embed(params, cfg, tokens[:, None], None, positions)  # (B, 1, dm)
    dymoe_on = qparams is not None and cfg.dymoe.enabled
    if kind == "attn_moe":
        return _decode_moe(params, cfg, x, caches,
                           qparams if dymoe_on else None, per_row_moe,
                           live_rows, moe_capacity, mesh)
    tier, shared = _layer_tier_flags(cfg), _shared_flags(cfg)
    site = _site_index(cfg)
    q = qparams["layers"] if dymoe_on else None
    for l in range(cfg.num_layers):
        lp = _index_tree(params["layers"], l)
        cache = caches["layers"].index(l)
        if shared[l]:
            x = _shared_block_decode(params, cfg, x,
                                     caches["shared"].index(site[l]),
                                     live_rows)
        if kind == "attn_dense":
            a, _ = attention_decode(lp["attn"], cfg,
                                    rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                    cache, live=live_rows, mesh=mesh)
            x = x + a
            x = x + _ffn(lp, q, cfg, l, tier[l],
                         rmsnorm(lp["norm2"], x, cfg.norm_eps))
        else:
            y, _ = mamba_decode(_ssm_params(lp, q, l, tier[l]), cfg,
                                rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                cache, live=live_rows)
            x = x + y
    logits = _lm_head(params, cfg,
                      rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0])
    return logits, caches, DyMoEInfo()


def _decode_moe(params, cfg: ModelConfig, x: torch.Tensor, caches,
                qparams: dict, per_row_moe: bool, live_rows, moe_capacity,
                mesh):
    """The MoE layer stack of :func:`decode_step`; ``qparams`` None runs
    the experts at full precision (every expert Critical)."""
    dymoe_on = qparams is not None
    b = x.shape[0]
    pol = cfg.dymoe
    e, k_tok = cfg.num_experts, cfg.num_experts_per_tok
    t_l = _t_l_array(cfg)
    crit_l, act_l, gm_l, pred_l = [], [], [], []
    for l in range(cfg.num_layers):
        lp = _index_tree(params["layers"], l)
        qm = _index_tree(qparams["layers"]["moe"], l) if dymoe_on else None
        a, _ = attention_decode(lp["attn"], cfg,
                                rmsnorm(lp["norm1"], x, cfg.norm_eps),
                                caches["layers"].index(l), live=live_rows,
                                mesh=mesh)
        x = x + a
        h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
        hflat = h.reshape(b, -1)
        pg = predict_next_gates(hflat, _next_router(params, cfg, l))
        imp = torch.softmax(hflat.to(torch.float32)
                            @ lp["moe"]["wg_router"], dim=-1) \
            if dymoe_on else None                                # (B, E)
        if per_row_moe and dymoe_on:
            # Eq. (3) per row: each request's Critical set from ITS OWN gates
            critical = select_critical_rows(imp, t_l[l])
            y, rstats = moe_apply_rows(lp["moe"], cfg, hflat, critical, qm,
                                       live=live_rows, capacity=moe_capacity)
            active, gate_mean = rstats["active"], rstats["gate_mean"]
        elif per_row_moe:
            # full precision: the rows run as one batch (no live mask, as
            # in the reference); only the telemetry is per row
            y, stats = moe_apply_sharded(lp["moe"], cfg, hflat)
            _, top = stable_topk(stats.router_logits, k_tok)
            active = torch.nn.functional.one_hot(top, e).sum(dim=1) > 0
            gate_mean = stats.gate_mean[None].expand(active.shape)
            critical = torch.ones_like(active)
        else:
            # Eq. (3): gate-guided importance of the batch-mean gate
            critical = select_critical(imp.mean(dim=0), t_l[l]) \
                if dymoe_on else None
            y, stats = moe_apply_sharded(lp["moe"], cfg, hflat,
                                         critical_mask=critical, qweights=qm)
            active, gate_mean = stats.expert_load > 0, stats.gate_mean
            if critical is None:
                critical = torch.ones((e,), dtype=torch.bool,
                                      device=x.device)
        if per_row_moe:
            _, freq = prefetch_targets(pg[:, None, :], k_tok,
                                       pol.prefetch_topk)        # (B, E)
        else:
            _, freq = prefetch_targets(pg, k_tok, pol.prefetch_topk)  # (E,)
        x = x + y.reshape(b, 1, -1)
        crit_l.append(critical)
        act_l.append(active)
        gm_l.append(gate_mean)
        pred_l.append(freq)
    logits = _lm_head(params, cfg,
                      rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, 0])
    pred = torch.stack(pred_l)
    pred[-1] = 0.0
    return logits, caches, DyMoEInfo(
        critical_masks=torch.stack(crit_l), active_masks=torch.stack(act_l),
        gate_mean=torch.stack(gm_l), predicted_next=pred)


_STEP_INFO = ("critical_masks", "active_masks", "gate_mean", "predicted_next")


def _stack_infos(infos: List[DyMoEInfo]) -> DyMoEInfo:
    """Per-step telemetry stacked along a leading step axis (None leaves,
    those of non-MoE archs, stay None)."""
    return DyMoEInfo(**{
        f: None if getattr(infos[0], f) is None
        else torch.stack([getattr(i, f) for i in infos])
        for f in _STEP_INFO})


def decode_many(params, cfg: ModelConfig, tokens: torch.Tensor,
                caches: Dict[str, Any], *, num_steps: int,
                start_step=0, qparams: Optional[dict] = None, rng_key=None,
                temperature=0.0, top_k: int = 0, row_keys=None,
                row_temperatures=None, row_top_ks=None, mesh=None,
                ) -> Tuple[torch.Tensor, Dict[str, Any], DyMoEInfo]:
    """``num_steps`` decode steps of one batch with one shared Critical
    set a layer (``decode_step(per_row_moe=False)``) — the path of
    ``generate_reference`` and of the static batch baseline (the engine
    runs it as a CUDA graph: ``serving/compiled.py``).

    tokens: (B,) — the last sampled token per sequence. Greedy unless
    ``rng_key`` is given and ``temperature > 0``; step ``i`` then draws
    with ``fold_in(rng_key, start_step + i)`` through
    :func:`repro_torch.serving.sampler.sample_token`, a counter-derived
    stream, so any chunking of the same request samples the same tokens.
    ``temperature > 0`` without a key falls back to greedy with a warning.
    ``start_step`` and ``temperature`` may be 0-d tensors (so a captured
    graph reads them from its inputs); a tensor ``temperature`` must be
    > 0 with ``rng_key`` given, as a traced one must in the reference.

    ``row_keys`` (B, 2), ``row_temperatures`` (B,) and ``row_top_ks``
    (B,) switch to PER-ROW sampling (the static batch): step ``i`` draws
    row r with ``fold_in(row_keys[r], start_step + i)`` through
    :func:`repro_torch.serving.sampler.sample_token_rows`, so each row's
    tokens equal a solo decode with that row's key; rows with temperature
    <= 0 stay greedy, and ``rng_key`` / ``temperature`` / ``top_k`` are
    ignored.

    Returns (tokens (num_steps, B) int32, caches (updated in place),
    DyMoEInfo with leaves (num_steps, L, E))."""
    # local import: serving depends on models, not the reverse
    from repro_torch.serving.sampler import fold_in, sample_token, \
        sample_token_rows

    row_mode = row_keys is not None
    concrete_t = not isinstance(temperature, torch.Tensor)
    if not row_mode and concrete_t and temperature > 0.0 and rng_key is None:
        warnings.warn("decode_many: temperature > 0 but no PRNG key was "
                      "provided; falling back to greedy decoding")
    greedy = not row_mode and (rng_key is None
                               or (concrete_t and temperature <= 0.0))
    tok = tokens.to(torch.int32)
    toks, infos = [], []
    for i in range(num_steps):
        logits, caches, info = decode_step(params, cfg, tok, caches,
                                           qparams=qparams, mesh=mesh)
        if row_mode:
            tok = sample_token_rows(
                logits, fold_in(row_keys, start_step + i),
                row_temperatures, row_top_ks)
        elif greedy:
            tok = sample_token(logits)
        else:
            tok = sample_token(logits, fold_in(rng_key, start_step + i),
                               temperature=temperature, top_k=top_k)
        toks.append(tok)
        infos.append(info)
    return torch.stack(toks), caches, _stack_infos(infos)


def _mask_info_rows(info: DyMoEInfo, live: torch.Tensor) -> DyMoEInfo:
    """Zero finished rows' telemetry (leaves (L, B, E) or None, live
    (B,))."""
    if info.critical_masks is None:
        return info
    m = live[None, :, None]
    return DyMoEInfo(critical_masks=info.critical_masks & m,
                     active_masks=info.active_masks & m,
                     gate_mean=info.gate_mean * m,
                     predicted_next=info.predicted_next * m)


def decode_many_batched(params, cfg: ModelConfig, tokens: torch.Tensor,
                        caches: Dict[str, Any], *, num_steps: int,
                        done: torch.Tensor, n_emitted: torch.Tensor,
                        limits: torch.Tensor, eos_tokens: torch.Tensor,
                        qparams: dict, live_cap: Optional[int] = None,
                        rng_keys: Optional[torch.Tensor] = None,
                        temperatures: Optional[torch.Tensor] = None,
                        top_ks: Optional[torch.Tensor] = None, mesh=None,
                        ) -> Tuple[torch.Tensor, Dict[str, Any],
                                   DyMoEInfo, torch.Tensor, torch.Tensor]:
    """Multi-step decode over a slot batch with a per-row done-mask — the
    device half of the continuous-batching scheduler.

    A row freezes once it emits its ``eos_tokens`` entry (-1 = none) or
    its ``n_emitted`` count reaches ``limits``: its token re-feeds
    unchanged, its KV writes and SSM state freeze at the write site (so
    the JAX package's whole-cache freeze has nothing left to do), and its
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
            params, cfg, tok, caches, qparams=qparams, per_row_moe=True,
            live_rows=live, moe_capacity=live_cap, mesh=mesh)
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
    return torch.stack(toks), caches, _stack_infos(infos), dn, emitted
