"""Partitioning rules: parameter path -> spec, with divisibility guards so
one rule set covers every architecture (torch copy of
``repro/sharding/partition.py``: the rule tables, the guards and the spec
builders are the same; the port keeps its own copy).

Baseline layout:
  * batch ("pod", "data"); tensor/model parallel "model".
  * Attention projections column/row split over "model".
  * Dense FFN Megatron column/row.
  * MoE experts: tensor-parallel *within* each expert (d_ff over "model")
    as the baseline; expert-parallel ("model" over E) with
    ``expert_parallel=True``.
  * KV caches: batch over ("pod", "data"), sequence slots over "model"
    (flash-decode style).
  * Quantized stores: packed/scales split along their N dim.

Any rule whose dimension does not divide the mesh axis degrades to
replication on that dimension (guarded).

A spec is a :class:`P`, a tuple with one entry per dim: None (whole) or
the mesh axes the dim is split over. The JAX package hands its specs to
``jax.device_put``; here :func:`shard_tree` keeps, on each rank, only its
own block of every leaf a spec splits — a :class:`Shard`, which the model
code computes with (``sharding/spmd.py``) — and leaves whole the leaves no
axis above 1 splits.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.kv_cache import KVCache, SSMCache
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor

__all__ = ["P", "MODEL_AXIS", "Shard", "param_shardings", "batch_spec",
           "cache_shardings", "zero1_shardings", "shard_tree", "guard_spec",
           "tree_specs"]

MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per dim, None or the mesh axes (a name
    or a tuple of names) that split it (``jax.sharding.PartitionSpec``'s
    counterpart)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def guard_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Drop spec entries whose dim is not divisible by the axis size."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axes in zip(shape, entries):
        if axes is not None and dim % _axis_size(mesh, axes) != 0:
            axes = None
        out.append(axes)
    return P(*out)


def batch_spec(mesh):
    """Composite batch axes present in the mesh ('pod' only in multi-pod)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


# --------------------------------------------------------------- param rules
#
# Rules are written on the TRAILING dims of each weight and right-aligned to
# the actual rank, so the same rule covers both per-layer and stacked
# (leading-L) layouts: e.g. wq rule (None, "model") applied to (L, dm, h·d)
# yields P(None, None, "model").

# (path regex, trailing-dim spec). Most-specific first.
_RULES = [
    # quantized stores: packed (.., N, K/vpb) / scales (.., G, N)
    (r"\.packed$", (MODEL_AXIS, None)),
    (r"\.scales$", (None, MODEL_AXIS)),
    # embeddings / unembedding
    (r"(^|/)embed$", (None, MODEL_AXIS)),
    (r"(^|/)lm_head$", (MODEL_AXIS, None)),
    # attention
    (r"/attn/w[qkv]$", (None, MODEL_AXIS)),
    (r"/attn/wo$", (MODEL_AXIS, None)),
    (r"/attn/b[qkv]$", (MODEL_AXIS,)),
    # dense mlp
    (r"/mlp/w_(gate|up)$", (None, MODEL_AXIS)),
    (r"/mlp/w_down$", (MODEL_AXIS, None)),
    # moe — router replicated; experts TP over d_ff (baseline)
    (r"/moe/wg_router$", (None, None)),
    (r"/moe/(shared_)?w_(gate|up)$", (None, None, MODEL_AXIS)),
    (r"/moe/(shared_)?w_down$", (None, MODEL_AXIS, None)),
    # mamba
    (r"/ssm/in_proj$", (None, MODEL_AXIS)),
    (r"/ssm/out_proj$", (MODEL_AXIS, None)),
    (r"/ssm/conv_w$", (MODEL_AXIS, None)),
    (r"/ssm/conv_b$", (MODEL_AXIS,)),
    (r"/ssm/x_proj$", (MODEL_AXIS, None)),
    (r"/ssm/dt_proj$", (None, MODEL_AXIS)),
    (r"/ssm/(dt_bias|d_skip)$", (MODEL_AXIS,)),
    (r"/ssm/a_log$", (MODEL_AXIS, None)),
    (r"/ssm/gate_norm/scale$", (MODEL_AXIS,)),
]

_EP_RULES = [
    # expert-parallel override: routed expert weights split over E.
    # Trailing-dims rules: float (E, K, N); packed (E, N, K/vpb);
    # scales (E, G, N) — E is dim -3 in all three. The quantized store
    # nests a precision level under each weight
    # (``w_gate/{high,low}/{packed,scales}``), so the optional
    # ``/(high|low)`` component must be matched or every quantized leaf
    # silently falls through to the intra-expert TP rules below.
    (r"/moe/w_(gate|up|down)(/(high|low))?(\.(packed|scales))?$",
     (MODEL_AXIS, None, None)),
]


def _children(node) -> Optional[list]:
    """(name, child) pairs of an inner node of a port tree, in the field
    order the JAX package's pytrees flatten them; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, MixedPrecisionWeights):
        return [("high", node.high), ("low", node.low)]
    if isinstance(node, QuantizedTensor):
        return [("packed", node.packed), ("scales", node.scales)]
    if isinstance(node, (KVCache, SSMCache)):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    return None


def _rebuild(node, values: dict):
    """``node`` with its children replaced by ``values`` (name -> value)."""
    if isinstance(node, dict):
        return {k: values[str(k)] for k in node}
    return dataclasses.replace(node, **values)


def tree_specs(tree: Any, leaf_fn, path: str = ""):
    """``leaf_fn(path, leaf)`` over the leaves of a port tree, the result
    in the tree's own structure (dicts, ``MixedPrecisionWeights``,
    ``QuantizedTensor``, ``KVCache`` / ``SSMCache``). ``path`` spells a
    leaf as the JAX package's ``_path_str`` does: "/" + the keys and field
    names joined by "/". A None child (a "4/0" store's ``low``) stays
    None."""
    kids = _children(tree)
    if kids is None:
        return leaf_fn(path, tree)
    return _rebuild(tree, {
        name: None if child is None
        else tree_specs(child, leaf_fn, f"{path}/{name}")
        for name, child in kids})


def _align(rule: Tuple, shape: Tuple[int, ...], lead_pad: int) -> P:
    """Right-align a trailing-dims rule to ``shape``, forcing the first
    ``lead_pad`` dims (the stacked-layer L dim) to None. Rules longer than
    the remaining rank keep their trailing entries."""
    nd = len(shape)
    body = nd - lead_pad
    rule = tuple(rule)[-body:] if body < len(rule) else tuple(rule)
    entries = [None] * (nd - len(rule)) + list(rule)
    return P(*entries)


def _spec_for(path_s: str, shape, mesh, expert_parallel: bool) -> P:
    # "/layers/" anywhere (params, or mu/nu inside optimizer state) marks
    # the stacked-layer layout with a leading L dim
    lead_pad = 1 if "/layers/" in path_s else 0
    if expert_parallel:
        for pat, rule in _EP_RULES:
            if re.search(pat, path_s):
                return guard_spec(_align(rule, shape, lead_pad), shape, mesh)
    for pat, rule in _RULES:
        if re.search(pat, path_s):
            return guard_spec(_align(rule, shape, lead_pad), shape, mesh)
    return P()


def param_shardings(tree: Any, mesh, *, expert_parallel: bool = False):
    """Spec tree for params / qparams / optimizer-state trees, in the
    tree's structure. A leaf needs only ``.shape``. ``QuantizedTensor``
    fields are reached as ``.../packed`` and normalised to
    ``....packed`` for the rule syntax, as the JAX package does."""
    def leaf_spec(path_s, leaf):
        path_s = re.sub(r"/(packed|scales)$", r".\1", path_s)
        if not hasattr(leaf, "shape"):
            return P()
        return _spec_for(path_s, tuple(leaf.shape), mesh, expert_parallel)

    return tree_specs(tree, leaf_spec)


# --------------------------------------------------------------- activations


def cache_shardings(tree: Any, mesh):
    """Decode-state specs for the STACKED cache layout (leading L or
    n_sites dim): KV k/v (L, B, Hkv, slots, D) — batch over (pod, data),
    slots over model (flash-decode style); positions (L, B, slots); SSM
    conv/ssm state split over the channel/head dim.

    The port's ``KVCache`` and ``SSMCache`` keep the JAX package's layout,
    so each reference dim is the port dim of the same place: k/v (L, B,
    H_kv, slots, D), positions (L, B, slots), length and offset (L, B);
    conv_state (L, B, C_conv, conv - 1), ssm_state (L, B, d_inner, N) or
    (L, B, heads, head_dim, N)."""
    b_axes = batch_spec(mesh)

    def leaf_spec(path_s, leaf):
        if not hasattr(leaf, "shape"):
            return P()
        nd = len(leaf.shape)
        if path_s.endswith("/k") or path_s.endswith("/v"):
            spec = P(None, b_axes, None, MODEL_AXIS, None)
        elif path_s.endswith("/positions"):
            spec = P(None, b_axes, MODEL_AXIS)
        elif path_s.endswith("/length"):
            spec = P(None, b_axes)
        elif path_s.endswith("/conv_state"):
            spec = P(None, b_axes, MODEL_AXIS, None)
        elif path_s.endswith("/ssm_state"):
            spec = P(None, b_axes, MODEL_AXIS, *([None] * (nd - 3)))
        else:
            spec = P(*([None] * nd))
        return guard_spec(spec, tuple(leaf.shape), mesh)

    return tree_specs(tree, leaf_spec)


def zero1_shardings(tree: Any, mesh, *, expert_parallel: bool = False):
    """ZeRO-1: optimizer-state specs = parameter specs PLUS the "data"
    axis on the first still-replicated divisible dim, so Adam moments stop
    being replicated across data-parallel replicas."""
    dsize = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    d_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)

    def leaf_spec(path_s, leaf):
        path_s = re.sub(r"/(packed|scales)$", r".\1", path_s)
        if not hasattr(leaf, "shape"):
            return P()
        shape = tuple(leaf.shape)
        base = _spec_for(path_s, shape, mesh, expert_parallel)
        if not shape:
            return base
        spec = list(base) + [None] * (len(shape) - len(base))
        for i, (dim, ax) in enumerate(zip(shape, spec)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                spec[i] = d_axes if len(d_axes) > 1 else d_axes[0]
                break
        return P(*spec)

    return tree_specs(tree, leaf_spec)


# ------------------------------------------------------------------ shards


class Shard:
    """This rank's block of a leaf whose spec splits dim ``dim`` over the
    mesh's "model" axis: ``local`` is the block ``[r·w, (r+1)·w)`` of that
    dim, r the rank's model coordinate and w = size / n. Indexing with an
    int (a stacked layer) gives the layer's Shard; every other use goes
    through ``sharding/spmd.py``, so a split weight can never be used as
    if it were whole."""

    __slots__ = ("local", "dim", "mesh")

    def __init__(self, local: torch.Tensor, dim: int, mesh):
        self.local, self.dim, self.mesh = local, dim, mesh

    def __repr__(self) -> str:
        return (f"Shard(shape={self.shape}, dim={self.dim}, "
                f"local={tuple(self.local.shape)})")

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.local.shape)
        s[self.dim] *= self.mesh.model_size
        return tuple(s)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def block(self) -> Tuple[int, int]:
        """[lo, hi) of this rank's block along ``dim``."""
        w = self.local.shape[self.dim]
        return self.mesh.model_rank * w, (self.mesh.model_rank + 1) * w

    def __getitem__(self, i):
        if not isinstance(i, int) or self.dim == 0:
            raise TypeError(f"{self!r}: only a leading int index (a stacked "
                            "layer) applies to a shard")
        return Shard(self.local[i], self.dim - 1, self.mesh)

    def to(self, device) -> "Shard":
        return Shard(self.local.to(device), self.dim, self.mesh)


def _split_dim(spec: P, mesh) -> Optional[int]:
    """The one dim ``spec`` splits over an axis above 1 (None: whole)."""
    dims = [d for d, axes in enumerate(spec)
            if axes is not None and _axis_size(mesh, axes) > 1]
    if not dims:
        return None
    if len(dims) > 1 or _axis_size(mesh, spec[dims[0]]) != mesh.model_size:
        raise NotImplementedError(
            f"spec {spec} on a {mesh.shape} mesh splits over a data or pod "
            "axis above 1: the next slice of the port (ROADMAP.md)")
    return dims[0]


def _block(t: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    w = t.shape[dim] // mesh.model_size
    return t.narrow(dim, mesh.model_rank * w, w).clone()


def shard_tree(tree: Any, specs: Any, mesh, device=None) -> Any:
    """Each rank's own part of ``tree`` under ``specs`` (a tree of
    :class:`P` in the same structure, from :func:`param_shardings` or
    :func:`cache_shardings`): a leaf a spec splits over an axis above 1
    becomes a :class:`Shard` holding only this rank's block (a copy, on
    ``device`` if given); a whole leaf stays as it is (moved to
    ``device``). A ``KVCache`` keeps plain local tensors and records in
    its static ``shards`` / ``shard`` how many ranks its slots are split
    over and which block it holds."""
    def move(t):
        return t if device is None else t.to(device)

    def walk(node, spec):
        if node is None:
            return None
        if isinstance(node, KVCache):
            out = {}
            split = dict(shards=1, shard=0)
            for name, t in _children(node):
                d = _split_dim(getattr(spec, name), mesh)
                out[name] = move(t if d is None else _block(t, d, mesh))
                if name == "k" and d is not None:
                    split = dict(shards=mesh.model_size,
                                 shard=mesh.model_rank)
            return dataclasses.replace(node, **out, **split)
        kids = _children(node)
        if isinstance(node, Shard):
            # already this rank's block (``init_sharded``): as the spec says
            if _split_dim(spec, mesh) != node.dim or node.mesh is not mesh:
                raise ValueError(f"{node!r} does not match spec {spec} on "
                                 f"{mesh!r}")
            return node if device is None else node.to(device)
        if kids is None:
            if not isinstance(node, torch.Tensor):
                return node
            d = _split_dim(spec, mesh)
            if d is None:
                return move(node)
            return Shard(move(_block(node, d, mesh)), d, mesh)
        if isinstance(node, SSMCache):
            for name, _ in kids:
                if _split_dim(getattr(spec, name), mesh) is not None:
                    raise NotImplementedError(
                        "SSM caches under a mesh: the next slice of the "
                        "port (ROADMAP.md)")
        spec_kids = dict(_children(spec))
        return _rebuild(node, {name: walk(child, spec_kids[name])
                               for name, child in kids})

    return walk(tree, specs)
