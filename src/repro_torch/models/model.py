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
constraint on the residual stream of the JAX package's training forward,
numerically the identity; here it splits the training forward's residual
between blocks along the sequence over "model" (:func:`forward`), and
with no mesh or one "model" rank it changes nothing. Prefill and decode
never read it.

Caches are written in place (see ``kv_cache.py`` and ``layers/ssm.py``):
{"layers": KVCache or SSMCache with a leading L, "shared": KVCache with a
leading n_sites (hybrid only)}.

``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) runs the inference
paths as one program on every rank of the mesh, over params and stores
that ``sharding/partition.py`` split over "model" (``Shard`` leaves) and KV
caches whose slots are split over "model" (``sharding/spmd.py`` places the
collectives, over each rank's "model" sub-group). The batch a function is
given is this rank's rows: its block of a batch split over the data axes
("pod", "data") when ``mesh``'s data axes are above 1 (``Mesh.for_batch``
gives the mesh a batch runs on; its ``model_view`` when the batch is
replicated, or its rows stay on one data rank). Rows are independent but
at the sites with one Critical mask: there the batch's tokens are gathered
over "data" and the site runs as one rank would (global capacity, token
order, Critical set and look-ahead), or, with ``cfg.moe_dispatch_axes``,
the rank dispatches its own groups and the batch's statistics are summed
over "data" (:func:`_site_split`). SSM blocks run on the rank's blocks of
the Mamba weights and states, bridged by collectives over "model"
(``layers/ssm.py``); the hybrid's shared sites run as dense attention
layers do, over KV caches whose slots are split over "model".

The train step runs under a mesh too (:func:`forward`, :func:`loss_fn`,
:func:`train_step_fn` given ``mesh``): a rank computes on its blocks of
the weights and its rows of the batch, every rank of a "model" sub-group
holds the one global loss whole, and each data rank's grads are its rows'
part of it, summed over ("pod", "data") at the end of the step. The
collectives carry the matching adjoints (``launch/mesh.py``); the MoE
sites gather their tokens over "data" as inference does, so the router
losses come from the whole batch, and enter the objective once
(``Mesh.count_once``).
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
from repro_torch.core.prefetch import predict_next_gates, prefetch_demand, \
    prefetch_sums, prefetch_targets
from repro_torch.core.schedule import critical_counts, retention_ratio
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_cache import KVCache, fill_kv_cache, init_kv_cache
from repro_torch.models.layers.attention import attention_decode, \
    attention_train
from repro_torch.models.layers.mlp import init_mlp, mlp, mlp_quantized
from repro_torch.models.layers.moe import dispatch_axes, local_dispatch, \
    moe_apply_prefill_rows, moe_apply_rows, moe_apply_sharded
from repro_torch.models.layers.norms import rmsnorm
from repro_torch.models.layers.rotary import sinusoidal_embedding
from repro_torch.models.layers.ssm import init_mamba, init_ssm_cache, \
    mamba_decode, mamba_prefill
from repro_torch.quant.qtensor import MixedPrecisionWeights
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import Shard, model_split
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
    pol = cfg.dymoe
    group, names = _quantized_group(cfg, params["layers"])
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


def _quantized_group(cfg: ModelConfig, layers: dict) -> Tuple[str, tuple]:
    """(the layer group, its weights) that :func:`quantize_model` packs."""
    kind = cfg.block_kinds()[0]
    if kind == "attn_moe":
        return "moe", ("w_gate", "w_up", "w_down")
    if kind == "attn_dense":
        return "mlp", tuple(layers["mlp"])
    return "ssm", ("in_proj", "out_proj")


class _Lazy:
    """A leaf ``init_params`` asked for, not drawn yet: its shape, dtype
    and draw (see :func:`init_sharded`)."""

    def __init__(self, shape, dtype, sample):
        self.shape, self.dtype, self.sample = tuple(shape), dtype, sample

    # the functions ``init_mamba`` applies to a draw (its ``dt_bias`` of
    # the uniforms): elementwise, so shape and dtype stay
    _ELEMENTWISE = (torch.exp, torch.expm1, torch.log)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """``func`` of the leaf, applied to the sample when it is drawn
        (the leaf itself, so its place in the draw order stays); any
        other use of an undrawn leaf raises."""
        if func not in cls._ELEMENTWISE or kwargs or len(args) != 1:
            raise TypeError(f"{func.__name__} of an undrawn leaf: only "
                            f"{[f.__name__ for f in cls._ELEMENTWISE]} apply")
        (lazy,) = args
        sample = lazy.sample
        lazy.sample = lambda shape: func(sample(shape))
        return lazy


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
    keeps its block. Returns (params, qparams or None)."""
    from repro_torch.sharding.partition import Shard, _block, _spec_for, \
        _split_dims, param_shardings, shard_tree, tree_specs

    _check_mesh(cfg, mesh)
    cfg.validate()
    device = resolve_device(generator.device if device is None else device)
    draw = _LazyDraw(generator, device, _dtype(cfg))
    lazy = _init_tree(cfg, draw)
    paths = {}
    tree_specs(lazy, lambda path, leaf: paths.setdefault(id(leaf), path))
    pol = cfg.dymoe
    group, qnames = _quantized_group(cfg, lazy["layers"])
    stacks: Dict[Any, Any] = {}

    def keep(key, path: str, t: torch.Tensor, l: int, n: int) -> None:
        """Layer ``l`` of the n-layer leaf at ``path``: this rank's block
        of ``t``, into its stack."""
        dims = _split_dims(_spec_for(path, (n,) + tuple(t.shape), mesh,
                                     expert_parallel), mesh)
        blk = _block(t, {d - 1: a for d, a in dims.items()}, mesh) \
            if dims else t
        if key not in stacks:
            buf = blk.new_empty((n,) + tuple(blk.shape))
            stacks[key] = Shard(buf, dims, mesh) if dims else buf
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
            and name in qnames
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
    """A MoE config's dispatch axes must name ``mesh``'s batch axes."""
    if mesh is not None and mesh.size > 1 and cfg.is_moe:
        dispatch_axes(cfg, mesh)


def _site_split(cfg: ModelConfig, mesh, t: int) -> Tuple[bool, bool]:
    """(gather, local) for a one-mask MoE site over this rank's ``t``
    tokens: with the batch split over ``mesh``'s data axes the site either
    gathers its tokens over "data" and runs as one rank would (the global
    capacity, token order, Critical set and look-ahead), or, with
    ``cfg.moe_dispatch_axes`` (:func:`local_dispatch`), dispatches its
    tokens where they are and sums its batch statistics over "data"."""
    if mesh is None or mesh.data_size == 1:
        return False, False
    local = local_dispatch(cfg, mesh, t)
    return not local, local


def _data_sums(mesh, *vecs: torch.Tensor) -> List[torch.Tensor]:
    """Each f32 vector summed over the data ranks, through one
    all_reduce."""
    sizes = [v.numel() for v in vecs]
    buf = torch.cat([v.reshape(-1).to(torch.float32) for v in vecs])
    return list(torch.split(mesh.all_reduce(buf, axis="data"), sizes))


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
    a whole prompt; returns (x, (k, v)). Under a mesh its projections are
    split as a dense layer's (``sharding/spmd.py``)."""
    sp = params["shared_attn"]
    a, _, kv = attention_train(sp["attn"], cfg,
                               rmsnorm(sp["norm1"], x, cfg.norm_eps))
    x = x + a
    x = x + mlp(sp["mlp"], cfg, rmsnorm(sp["norm2"], x, cfg.norm_eps))
    return x, kv


def _shared_block_decode(params, cfg: ModelConfig, x: torch.Tensor,
                         cache: KVCache, live: Optional[torch.Tensor],
                         mesh=None):
    sp = params["shared_attn"]
    a, _ = attention_decode(sp["attn"], cfg,
                            rmsnorm(sp["norm1"], x, cfg.norm_eps), cache,
                            live=live, mesh=mesh)
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
    if isinstance(tree, Shard):
        splits = {d - 1: a for d, a in tree.splits.items()}
        return [Shard(t, splits, tree.mesh)
                for t in torch.unbind(tree.local, 0)]
    return list(torch.unbind(tree, 0))


def _train_block(params, cfg: ModelConfig, kind: str, shared: bool,
                 lp: dict, x: torch.Tensor, aux: torch.Tensor, mesh=None,
                 seq: Optional[int] = None):
    """One layer of :func:`forward`; returns (x, aux). ``seq``: ``x`` is
    this rank's block of a sequence of ``seq`` positions, gathered whole
    for the layer and cut back to the block at its end (a checkpoint then
    saves the block, and issues the gather again when it recomputes)."""
    if seq is None:
        return _block(params, cfg, kind, shared, lp, x, aux, mesh)
    x, aux = _block(params, cfg, kind, shared, lp,
                    spmd.seq_enter(x, mesh, seq), aux, mesh)
    return spmd.seq_leave(x, mesh), aux


def _block(params, cfg: ModelConfig, kind: str, shared: bool, lp: dict,
           x: torch.Tensor, aux: torch.Tensor, mesh=None):
    """One layer over the whole sequence (the hybrid's shared block first
    where it runs); returns (x, aux)."""
    if shared:
        x = _shared_block_train(params, cfg, x)[0]
    if kind == "ssm":
        # a fresh zero state a call, as the reference's init_ssm_cache
        y, _ = mamba_prefill(lp["ssm"], cfg,
                             rmsnorm(lp["norm1"], x, cfg.norm_eps), None,
                             mesh)
        return x + y, aux
    a, _, _ = attention_train(lp["attn"], cfg,
                              rmsnorm(lp["norm1"], x, cfg.norm_eps))
    x = x + a
    h = rmsnorm(lp["norm2"], x, cfg.norm_eps)
    if kind == "attn_dense":
        return x + mlp(lp["mlp"], cfg, h), aux
    b, s, _ = h.shape
    y, stats = moe_apply_sharded(lp["moe"], cfg, h.reshape(b * s, -1),
                                 mesh=mesh)
    return x + y.reshape(b, s, -1), aux + stats.aux_loss


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor] = None,
            *, embeds: Optional[torch.Tensor] = None, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward. Returns (logits (B,S,V) f32, aux_loss scalar: the
    MoE router losses summed over the layers). ``cfg.remat == "block"``
    recomputes each block in the backward pass (``jax.checkpoint``'s
    counterpart, non-reentrant activation checkpointing; a block's
    collectives are issued again then). ``mesh``: run as one rank of it,
    on its blocks of the weights and its rows of the batch (the module
    docstring); the logits are this rank's rows, the aux loss the whole
    batch's. ``cfg.act_seq_shard`` with more than one "model" rank: the
    residual between blocks is this rank's block of the sequence
    (``spmd.seq_leave`` / ``seq_enter``), so each checkpoint saves 1 /
    model ranks of it; the blocks and the logits are unchanged, bit for
    bit."""
    _check_mesh(cfg, mesh)
    x = _embed(params, cfg, tokens, embeds)
    kind = cfg.block_kinds()[0]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    split = cfg.act_seq_shard and mesh is not None and mesh.model_size > 1
    seq = x.shape[1] if split else None
    if seq is not None:
        x = spmd.seq_leave(x, mesh)
    layers = _unbind_layers(params["layers"], cfg.num_layers)
    for lp, shared in zip(layers, _shared_flags(cfg)):
        if cfg.remat == "block":
            x, aux = checkpoint(_train_block, params, cfg, kind, shared, lp,
                                x, aux, mesh, seq, use_reentrant=False)
        else:
            x, aux = _train_block(params, cfg, kind, shared, lp, x, aux,
                                  mesh, seq)
    if seq is not None:
        x = spmd.seq_enter(x, mesh, seq)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _lm_head(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked mean next-token NLL plus the router losses; returns (loss,
    {"ce", "aux"}). ``batch``: "tokens" (or "embeds"), "labels", and an
    optional "loss_mask".

    ``mesh`` (its data axes above 1): ``batch`` holds this rank's rows of
    the global batch, and the mean is the global batch's — the rank's
    NLL sum and mask count summed over "data" (the mask a constant), so
    the value is whole on every rank and its grads reach this rank's rows
    only; the router losses, whole on every rank, enter the grads of data
    rank 0 alone (``Mesh.count_once``), so the data ranks' sum counts
    them once."""
    logits, aux = forward(params, cfg, batch.get("tokens"),
                          embeds=batch.get("embeds"), mesh=mesh)
    labels = batch["labels"].to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    if mesh is None or mesh.data_size == 1:
        ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return ce + aux, {"ce": ce, "aux": aux}
    sums = mesh.all_reduce(torch.stack([(nll * mask).sum(),
                                        mask.sum().detach()]), axis="data")
    ce = sums[0] / torch.clamp(sums[1], min=1.0)
    return ce + mesh.count_once(aux), {"ce": ce, "aux": aux}


def train_step_fn(cfg: ModelConfig, optimizer, mesh=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "ce", "aux"})``: the grads of :func:`loss_fn` over every
    param leaf by ``torch.autograd.grad``, then ``optimizer.update``. The
    params given are not modified.

    ``mesh``: the step of one rank of it. ``params`` and the moments of
    ``opt_state`` are the rank's trees (``Shard`` leaves: its blocks under
    ``param_shardings``, the moments also under ``zero1_shardings``),
    ``batch`` its rows of the global batch (``Mesh.batch_block``). The
    grads of every leaf (whole over "data") are summed over ("pod",
    "data") through one collective a dtype before the update; the step
    returns the rank's new blocks and the metrics, whole on every rank."""

    def step(params, opt_state, batch):
        leaves: List[torch.Tensor] = []

        def track(p):
            t = (p.local if isinstance(p, Shard) else p).detach()
            leaves.append(t.requires_grad_(True))
            return Shard(t, p.splits, p.mesh) if isinstance(p, Shard) else t

        with torch.enable_grad():
            loss, metrics = loss_fn(tree_map(track, params), cfg, batch,
                                    mesh=mesh)
            found = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach: the zero grad jax.grad gives
        found = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(leaves, found)]
        if mesh is not None and mesh.data_size > 1:
            found = mesh.sum_flat(found, axis="data")
        found = iter(found)
        grads = tree_map(lambda p: Shard(next(found), p.splits, p.mesh)
                         if isinstance(p, Shard) else next(found), params)
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
                                           layers=cfg.num_layers, mesh=mesh)}
    else:
        caches = {"layers": init_kv_cache(b, cfg.num_kv_heads, slots,
                                          cfg.head_dim, dt, dev,
                                          layers=cfg.num_layers, ring=ring,
                                          **model_split(mesh, slots))}
    if hybrid:
        caches["shared"] = init_kv_cache(b, cfg.num_kv_heads, slots,
                                         cfg.head_dim, dt, dev,
                                         layers=_n_sites(cfg), ring=ring,
                                         **model_split(mesh, slots))
    dymoe_on = qparams is not None and cfg.dymoe.enabled
    if kind == "attn_moe":
        x, info = _prefill_moe(params, cfg, x, caches["layers"],
                               qparams if dymoe_on else None,
                               lengths=lengths, offsets=offsets, valid=valid,
                               positions=positions, row_local=row_local,
                               row_capacities=row_capacities, mesh=mesh)
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
                                     caches["layers"].index(l), mesh)
                x = x + y
        info = DyMoEInfo()
    logits = _lm_head(params, cfg, rmsnorm(params["final_norm"], x[:, -1],
                                           cfg.norm_eps))
    return logits, caches, info


def _prefill_moe(params, cfg: ModelConfig, x: torch.Tensor, caches: KVCache,
                 qparams: dict, *, lengths, offsets, valid, positions,
                 row_local: bool, row_capacities, mesh):
    """The MoE layer stack of :func:`prefill`; returns (x, DyMoEInfo).
    ``qparams`` None runs the experts at full precision, as the reference
    does with DyMoE off: every expert Critical, no heavy hitters. On a
    batch split over ``mesh``'s data axes the one-mask site gathers or
    sums over "data" (:func:`_site_split`); a row-local one needs nothing
    but its rows."""
    dymoe_on = qparams is not None
    b, s = x.shape[:2]
    pol = cfg.dymoe
    e, k_tok = cfg.num_experts, cfg.num_experts_per_tok
    t_l = _t_l_array(cfg)
    vflat = valid.reshape(b * s) if valid is not None else None
    gather, local = (False, False) if row_local else \
        _site_split(cfg, mesh, b * s)
    lo = mesh.data_rank * b * s if gather else 0
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
        # the site's tokens: this rank's, or every data rank's (gather)
        hs, hhs, vs = hflat, hh, vflat
        if gather:
            hs, hhs, vs = (None if t is None
                           else mesh.all_gather(t, 0, axis="data")
                           for t in (hflat, hh, vflat))
        # look-ahead (Eq. 6-7) for the next layer's prefetcher
        pg = predict_next_gates(hs, _next_router(params, cfg, l))
        if dymoe_on or row_local:
            # router pre-pass: pick the Critical set BEFORE expert compute
            # (Eq. 1-2 -> Eq. 5); ties broken by lower index
            probs_r = torch.softmax(hs.to(torch.float32)
                                    @ lp["moe"]["wg_router"], dim=-1)
            gates_r, idx_r = stable_topk(probs_r, k_tok)
            oh = torch.nn.functional.one_hot(idx_r, e).to(torch.float32)
            if vs is not None:                       # pads route nowhere
                oh = oh * vs.to(torch.float32)[:, None, None]
        if row_local and not dymoe_on:
            # full precision: the wave's experts run as one batch; only
            # the telemetry is per row
            oh_r = oh.reshape(b, s, k_tok, e)
            load_rows = oh_r.sum(dim=(1, 2))                     # (B, E)
            y, st = moe_apply_sharded(lp["moe"], cfg, hflat,
                                      token_valid=vflat, mesh=mesh)
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
            parts = list(prefetch_sums(pg, k_tok, vs)) if local else []
            if dymoe_on:
                hh_load_e = torch.einsum("tke,t->e", oh, hhs)
                load_e = oh.sum(dim=(0, 1))
                if local:   # the batch's loads: summed over the data ranks
                    hh_load_e, load_e, *parts = _data_sums(
                        mesh, hh_load_e, load_e, *parts)
                imp = prefill_expert_importance(hh_load_e, load_e)
                critical = select_critical(imp, t_l[l])
            elif local:
                parts = _data_sums(mesh, *parts)
            y, st = moe_apply_sharded(lp["moe"], cfg, hs,
                                      critical_mask=critical, qweights=qm,
                                      hh_mask=hhs, token_valid=vs,
                                      mesh=mesh if local else None)
            y = y[lo:lo + b * s]
            if critical is None:
                critical = torch.ones((e,), dtype=torch.bool,
                                      device=x.device)
            active, load, hh_load, gate_mean = (
                st.expert_load > 0, st.expert_load, st.expert_hh_load,
                st.gate_mean)
            aux, dropped = st.aux_loss, st.dropped_frac
        x = x + y.reshape(b, s, -1)
        if row_local:   # per-row Eq. 7: each admission's own demand
            _, freq = prefetch_targets(pg.reshape(b, s, e), k_tok,
                                       pol.prefetch_topk, token_valid=valid)
        elif local:
            _, freq = prefetch_demand(*parts, pol.prefetch_topk)
        else:
            _, freq = prefetch_targets(pg, k_tok, pol.prefetch_topk,
                                       token_valid=vs)
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
    shared-site KV caches do. Under ``mesh`` ``batch`` is the rows this
    rank holds (its block of a batch split over the data axes, or the
    whole batch where it is replicated) and a rank allocates only its
    block of the slots, and of an SSM state's channels or heads, where
    "model" divides them (``cache_shardings``' layout)."""
    _check_mesh(cfg, mesh)
    device = resolve_device(device)
    dt = _dtype(cfg)
    slots = min(seq_len, cfg.sliding_window) if cfg.sliding_window \
        else seq_len
    ring = cfg.sliding_window is not None and slots == cfg.sliding_window
    if cfg.block_kinds()[0] == "ssm":
        caches = {"layers": init_ssm_cache(cfg, batch, dt, device,
                                           layers=cfg.num_layers, mesh=mesh)}
    else:
        caches = {"layers": init_kv_cache(batch, cfg.num_kv_heads, slots,
                                          cfg.head_dim, dt, device,
                                          layers=cfg.num_layers, ring=ring,
                                          **model_split(mesh, slots))}
    if cfg.shared_attn_every:
        caches["shared"] = init_kv_cache(batch, cfg.num_kv_heads, slots,
                                         cfg.head_dim, dt, device,
                                         layers=_n_sites(cfg), ring=ring,
                                         **model_split(mesh, slots))
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
                                     live_rows, mesh)
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
                                cache, live=live_rows, mesh=mesh)
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
    gather, local = (False, False) if per_row_moe else \
        _site_split(cfg, mesh, b)
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
        # the site's rows: this rank's, or every data rank's (gather)
        hs = mesh.all_gather(hflat, 0, axis="data") if gather else hflat
        pg = predict_next_gates(hs, _next_router(params, cfg, l))
        imp = torch.softmax(hs.to(torch.float32)
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
            y, stats = moe_apply_sharded(lp["moe"], cfg, hflat, mesh=mesh)
            _, top = stable_topk(stats.router_logits, k_tok)
            active = torch.nn.functional.one_hot(top, e).sum(dim=1) > 0
            gate_mean = stats.gate_mean[None].expand(active.shape)
            critical = torch.ones_like(active)
        else:
            # Eq. (3): gate-guided importance of the batch-mean gate
            critical = None
            if local:   # the batch's sums: over the data ranks
                parts = _data_sums(mesh, *([imp.sum(dim=0)] if dymoe_on
                                           else []),
                                   *prefetch_sums(pg, k_tok))
                if dymoe_on:
                    critical = select_critical(
                        parts.pop(0) / (b * mesh.data_size), t_l[l])
            elif dymoe_on:
                critical = select_critical(imp.mean(dim=0), t_l[l])
            y, stats = moe_apply_sharded(lp["moe"], cfg, hs,
                                         critical_mask=critical, qweights=qm,
                                         mesh=mesh if local else None)
            if gather:
                y = y[mesh.data_rank * b:(mesh.data_rank + 1) * b]
            active, gate_mean = stats.expert_load > 0, stats.gate_mean
            if critical is None:
                critical = torch.ones((e,), dtype=torch.bool,
                                      device=x.device)
        if per_row_moe:
            _, freq = prefetch_targets(pg[:, None, :], k_tok,
                                       pol.prefetch_topk)        # (B, E)
        elif local:
            _, freq = prefetch_demand(*parts, pol.prefetch_topk)
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
