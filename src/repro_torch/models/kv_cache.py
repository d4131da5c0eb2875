"""Decode-time state (torch twin of ``repro/models/kv_cache.py``): the
full KV cache, the ring-buffer (sliding-window) KV cache and the SSM
recurrent state.

A ring cache holds a window of W slots that decode overwrites
cyclically: the token at absolute position p lives in slot p % W, and
each slot remembers the position it holds, so attention's window mask
stays exact.

Unlike the JAX package, whose arrays are immutable, the port writes a
decode step into the cache IN PLACE (one slot per row) instead of copying
the whole cache every step; ``update_kv_cache`` returns the same object,
and the Mamba blocks (``layers/ssm.py``) write their ``SSMCache`` in place
too.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

__all__ = ["KVCache", "SSMCache", "init_kv_cache", "update_kv_cache",
           "fill_kv_cache", "cache_tensors"]


@dataclasses.dataclass
class KVCache:
    """k/v: (B, H_kv, S_slots, D). positions: (B, S_slots) absolute
    position held by each slot (-1 = empty). length: (B,) tokens seen.
    offset: (B,) pad slots before the row's content (a right-aligned
    ragged prefill pads rows on the LEFT), so a new token at logical
    position ``length`` lands in slot ``length + offset``. ``ring``, a
    static flag, says the S_slots are a sliding window: a new token then
    lands in slot ``(length + offset) % S_slots`` instead of the last
    slot. Stacked caches carry a leading layer dim on every tensor;
    :meth:`index` views layer l.

    ``shards`` / ``shard`` (static) say the slots are split over that many
    ranks of a mesh's "model" axis (``sharding/partition.py``'s
    ``cache_shardings``): this cache holds the block ``shard`` of the
    ``shards × S_slots`` slots, and a write lands on the rank that owns its
    slot. A split cache's prefill lays every row out LEFT-aligned (offset
    0): a right-aligned row would have to be rolled across ranks.
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    length: torch.Tensor
    offset: torch.Tensor
    ring: bool = dataclasses.field(default=False,
                                   metadata=dict(static=True))
    shards: int = dataclasses.field(default=1, metadata=dict(static=True))
    shard: int = dataclasses.field(default=0, metadata=dict(static=True))

    def index(self, i) -> "KVCache":
        return KVCache(k=self.k[i], v=self.v[i], positions=self.positions[i],
                       length=self.length[i], offset=self.offset[i],
                       ring=self.ring, shards=self.shards, shard=self.shard)

    def slot_block(self) -> Tuple[int, int]:
        """(first global slot of this block, global slot count)."""
        n = self.k.shape[-2]
        return self.shard * n, self.shards * n


@dataclasses.dataclass
class SSMCache:
    """conv_state: (B, C_conv, conv - 1) the last conv - 1 inputs of the
    causal conv, oldest first, in the model's dtype; ssm_state: f32, mamba1
    (B, d_inner, N) or mamba2 (B, heads, head_dim, N); length: (B,)
    tokens seen. Stacked caches carry a leading layer dim on every field;
    :meth:`index` views layer l."""

    conv_state: torch.Tensor
    ssm_state: torch.Tensor
    length: torch.Tensor

    def index(self, i) -> "SSMCache":
        return SSMCache(conv_state=self.conv_state[i],
                        ssm_state=self.ssm_state[i], length=self.length[i])


def cache_tensors(cache) -> List[Tuple[str, torch.Tensor]]:
    """A KVCache's or SSMCache's tensors as (name, tensor) pairs, in field
    order (a KVCache's static ``ring`` flag left out)."""
    return [(f.name, getattr(cache, f.name))
            for f in dataclasses.fields(cache) if not f.metadata.get("static")]


def init_kv_cache(batch: int, num_kv_heads: int, slots: int, head_dim: int,
                  dtype=torch.bfloat16, device=None,
                  layers: Optional[int] = None, ring: bool = False,
                  shards: int = 1, shard: int = 0) -> KVCache:
    """Empty cache; ``layers`` adds the leading stacked layer dim;
    ``ring`` makes the slots a sliding window; ``shards`` > 1 keeps only
    block ``shard`` of the ``slots`` (see :class:`KVCache`)."""
    lead = () if layers is None else (layers,)
    assert slots % shards == 0, (slots, shards)
    slots //= shards
    return KVCache(
        k=torch.zeros(lead + (batch, num_kv_heads, slots, head_dim),
                      dtype=dtype, device=device),
        v=torch.zeros(lead + (batch, num_kv_heads, slots, head_dim),
                      dtype=dtype, device=device),
        positions=torch.full(lead + (batch, slots), -1, dtype=torch.int32,
                             device=device),
        length=torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device),
        offset=torch.zeros(lead + (batch,), dtype=torch.int32,
                           device=device),
        ring=ring, shards=shards, shard=shard,
    )


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    live: Optional[torch.Tensor] = None) -> KVCache:
    """Insert one decode step IN PLACE. k_new/v_new: (B, H_kv, 1, D).

    ``live`` (B,) bool: False rows are frozen — their frontier slot keeps
    its old contents and their position marker / length don't advance.
    As in the JAX package the masking happens at the write site (the old
    slot values are written back), so no row index is read on the host.
    A ring cache writes slot ``frontier % slots``; a full one clamps at
    its last slot. A split cache (``shards`` > 1) writes only the rows
    whose slot lies in its block (the others write their old values
    back); every block advances ``length``."""
    b = cache.k.shape[0]
    lo, slots = cache.slot_block()
    pos = cache.length                                   # (B,) int32
    frontier = pos + cache.offset
    slot = (frontier % slots if cache.ring
            else torch.clamp(frontier, max=slots - 1)).long()
    bidx = torch.arange(b, device=cache.k.device)
    kw = k_new[:, :, 0].to(cache.k.dtype)
    vw = v_new[:, :, 0].to(cache.v.dtype)
    pw = pos
    length = cache.length + 1
    write = None if live is None else live.to(torch.bool)
    if cache.shards > 1:
        n = cache.k.shape[-2]
        own = (slot >= lo) & (slot < lo + n)
        slot = torch.clamp(slot - lo, 0, n - 1)
        write = own if write is None else own & write
    if write is not None:
        kw = torch.where(write[:, None, None], kw, cache.k[bidx, :, slot])
        vw = torch.where(write[:, None, None], vw, cache.v[bidx, :, slot])
        pw = torch.where(write, pos, cache.positions[bidx, slot])
    if live is not None:
        length = torch.where(live.to(torch.bool), length, cache.length)
    cache.k[bidx, :, slot] = kw
    cache.v[bidx, :, slot] = vw
    cache.positions[bidx, slot] = pw
    cache.length.copy_(length)
    return cache


def fill_kv_cache(cache: KVCache, k_seq: torch.Tensor, v_seq: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  offsets: Optional[torch.Tensor] = None) -> KVCache:
    """Bulk insert a prefill sequence at slot 0, in place. k_seq/v_seq:
    (B, H_kv, S, D). ``lengths`` (B,): per-row true token counts;
    ``offsets`` (B,): pad slots before each row's content (right-aligned
    ragged layout) — slots outside ``[offset, offset + length)`` are
    marked empty so attention never reads a pad.

    A ring cache given more keys than slots (S > slots) keeps the
    trailing ``slots`` keys, the key at absolute position p in slot
    p % slots, as :func:`update_kv_cache` lays them out, so decode
    continues seamlessly; its length is S. Ragged offsets are refused
    there, as in the JAX package.

    A split cache (``shards`` > 1) keeps its block of that layout, but
    with every row LEFT-aligned (logical position j in global slot j,
    offset 0; see :class:`KVCache`)."""
    if cache.shards > 1:
        return _fill_split(cache, k_seq, v_seq, lengths, offsets)
    b, _, s, _ = k_seq.shape
    slots = cache.k.shape[2]
    dev = cache.k.device
    if s > slots:
        assert cache.ring, (s, slots)
        assert offsets is None, "ragged offsets unsupported for ring caches"
        # key i of the kept tail holds position s - slots + i, so it goes
        # to slot (s + i) % slots: the tail rolled by s % slots
        r = s % slots
        cache.k.copy_(torch.roll(k_seq[:, :, s - slots:], r, dims=2))
        cache.v.copy_(torch.roll(v_seq[:, :, s - slots:], r, dims=2))
        pos = torch.roll(torch.arange(s - slots, s, dtype=torch.int32,
                                      device=dev), r)
        cache.positions.copy_(pos[None].expand(b, slots))
        cache.length.fill_(s)
        cache.offset.zero_()
        return cache
    cache.k[:, :, :s] = k_seq.to(cache.k.dtype)
    cache.v[:, :, :s] = v_seq.to(cache.v.dtype)
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    if offsets is None:
        offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    slot = torch.arange(slots, dtype=torch.int32, device=dev)[None, :]
    pos = slot - offsets[:, None]
    filled = (pos >= 0) & (pos < lengths[:, None])
    cache.positions.copy_(torch.where(filled, pos, torch.full_like(pos, -1)))
    cache.length.copy_(lengths)
    cache.offset.copy_(offsets)
    return cache


def _fill_split(cache: KVCache, k_seq: torch.Tensor, v_seq: torch.Tensor,
                lengths: Optional[torch.Tensor],
                offsets: Optional[torch.Tensor]) -> KVCache:
    """:func:`fill_kv_cache` into this rank's block of a split cache."""
    b, h, s, d = k_seq.shape
    lo, slots = cache.slot_block()
    n = cache.k.shape[2]
    dev = cache.k.device
    g = lo + torch.arange(n, dtype=torch.int64, device=dev)  # global slots
    if s > slots:
        assert cache.ring, (s, slots)
        assert offsets is None, "ragged offsets unsupported for ring caches"
        # the kept tail rolled by s % slots (fill_kv_cache's layout):
        # global slot j holds position s - slots + (j - s % slots) % slots
        pos = (s - slots) + (g - s % slots) % slots
        cache.k.copy_(k_seq[:, :, pos])
        cache.v.copy_(v_seq[:, :, pos])
        cache.positions.copy_(pos.to(torch.int32)[None].expand(b, n))
        cache.length.fill_(s)
        cache.offset.zero_()
        return cache
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=dev)
    if offsets is None:
        offsets = torch.zeros((b,), dtype=torch.int32, device=dev)
    filled = g[None, :] < lengths[:, None]                     # (B, n)
    src = torch.clamp(offsets[:, None].to(torch.int64) + g[None, :],
                      max=s - 1)
    idx = src[:, None, :, None].expand(b, h, n, d)
    keep = filled[:, None, :, None]
    zero = torch.zeros((), dtype=cache.k.dtype, device=dev)
    cache.k.copy_(torch.where(keep, torch.gather(k_seq, 2, idx).to(
        cache.k.dtype), zero))
    cache.v.copy_(torch.where(keep, torch.gather(v_seq, 2, idx).to(
        cache.v.dtype), zero))
    cache.positions.copy_(torch.where(filled, g.to(torch.int32)[None, :],
                                      torch.full_like(cache.positions, -1)))
    cache.length.copy_(lengths)
    cache.offset.zero_()
    return cache
