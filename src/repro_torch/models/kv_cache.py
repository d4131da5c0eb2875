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
    """

    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor
    length: torch.Tensor
    offset: torch.Tensor
    ring: bool = dataclasses.field(default=False,
                                   metadata=dict(static=True))

    def index(self, i) -> "KVCache":
        return KVCache(k=self.k[i], v=self.v[i], positions=self.positions[i],
                       length=self.length[i], offset=self.offset[i],
                       ring=self.ring)


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
                  layers: Optional[int] = None, ring: bool = False
                  ) -> KVCache:
    """Empty cache; ``layers`` adds the leading stacked layer dim;
    ``ring`` makes the slots a sliding window."""
    lead = () if layers is None else (layers,)
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
        ring=ring,
    )


def update_kv_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    live: Optional[torch.Tensor] = None) -> KVCache:
    """Insert one decode step IN PLACE. k_new/v_new: (B, H_kv, 1, D).

    ``live`` (B,) bool: False rows are frozen — their frontier slot keeps
    its old contents and their position marker / length don't advance.
    As in the JAX package the masking happens at the write site (the old
    slot values are written back), so no row index is read on the host.
    A ring cache writes slot ``frontier % slots``; a full one clamps at
    its last slot."""
    b, _, slots, _ = cache.k.shape
    pos = cache.length                                   # (B,) int32
    frontier = pos + cache.offset
    slot = (frontier % slots if cache.ring
            else torch.clamp(frontier, max=slots - 1)).long()
    bidx = torch.arange(b, device=cache.k.device)
    kw = k_new[:, :, 0].to(cache.k.dtype)
    vw = v_new[:, :, 0].to(cache.v.dtype)
    pw = pos
    length = cache.length + 1
    if live is not None:
        lv = live.to(torch.bool)
        kw = torch.where(lv[:, None, None], kw, cache.k[bidx, :, slot])
        vw = torch.where(lv[:, None, None], vw, cache.v[bidx, :, slot])
        pw = torch.where(lv, pos, cache.positions[bidx, slot])
        length = torch.where(lv, length, cache.length)
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
    there, as in the JAX package."""
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
