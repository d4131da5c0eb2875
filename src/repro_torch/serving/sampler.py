"""Token sampling (torch port of ``repro/serving/sampler.py``): greedy /
temperature / top-k, plus the per-row variant the continuous-batching
scheduler threads through the decode chunk (every slot carries its own
temperature / top-k / PRNG stream).

The PRNG is jax's threefry2x32 rebuilt in torch integer ops, so a key and
the bits, uniforms, Gumbels and categorical draws made from it equal
``jax.random``'s under jax's partitionable threefry
(``jax_threefry_partitionable=True``, the default of the installed jax)
with 64-bit mode off. A key is a raw (..., 2) pair of uint32 words held in
an int64 tensor; every word operation masks back to 32 bits, because
torch has no shifts on ``uint32``. Explicit keys only: nothing here reads
torch's global RNG, and nothing syncs the device with the host.
"""
from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "bits", "uniform", "gumbel", "categorical",
           "sample_token", "sample_token_rows", "raw_key_data",
           "resolve_sampling"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, d: int) -> torch.Tensor:
    return ((v << d) & _MASK) | (v >> (32 - d))


def _threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) on broadcastable int64
    tensors of uint32 words: returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key) -> torch.Tensor:
    """A raw key (or a (..., 2) stack of them) as an int64 tensor."""
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64) & _MASK
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64))


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: the key
    ``[0, seed mod 2**32]`` (an int64 CPU tensor of two uint32 words)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def fold_in(key, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32 of the counter ``(0, data)``
    under ``key``. ``key`` (..., 2) and ``data`` (...) broadcast, so a
    (B, 2) stack of row keys folds a (B,) tensor of per-row counts in one
    call."""
    k = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & _MASK
    else:   # a fill, not a host-to-device copy: no sync on the card
        d = torch.full(k.shape[:-1], int(data) & _MASK, dtype=torch.int64,
                       device=k.device)
    y0, y1 = _threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def bits(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit, partitionable threefry):
    the counter of each element is its flat index in ``shape``, and the
    bits are the xor of the cipher's two words. A (..., 2) stack of keys
    gives (..., *shape), each slice drawn from its own key. Returns int64
    holding uint32 values."""
    k = _words(key)
    shape = tuple(shape)
    n = int(np.prod(shape)) if shape else 1
    lead = k.shape[:-1]
    ctr = torch.arange(n, dtype=torch.int64, device=k.device)
    k0 = k[..., 0].reshape(lead + (1,))
    k1 = k[..., 1].reshape(lead + (1,))
    y0, y1 = _threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return (y0 ^ y1).reshape(lead + shape)


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled to [minval, maxval)."""
    b = bits(key, shape)
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # f32 bounds, passed as Python scalars (a scalar tensor on the card
    # would cost a host-to-device copy). XLA fuses jax's f32 `f * (hi -
    # lo) + lo` into one multiply-add: the product is exact in f64, so
    # the f64 sum rounded to f32 gives its single rounding
    lo, hi = np.float32(minval), np.float32(maxval)
    u = (f.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp(u, min=float(lo))


def gumbel(key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in f32 (the default, low mode)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(key, shape, minval=tiny)))


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical``: ``argmax(gumbel(key, logits.shape) +
    logits)`` (first maximum)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=axis)


def resolve_sampling(request, rng_key=None, *, context: str):
    """A request's EFFECTIVE sampling state, the contract every serving
    path shares: the PRNG stream root is ``rng_key`` if given, else
    ``PRNGKey(request.seed)``; ``temperature > 0`` with neither falls back
    to greedy with a warning (a keyless request cannot crash the serving
    loop). Returns ``(temperature, top_k, key-or-None)``."""
    key = rng_key
    if key is None and request.seed is not None:
        key = PRNGKey(request.seed)
    if request.temperature > 0.0 and key is None:
        warnings.warn(
            f"{context}: temperature > 0 but neither a seed nor an "
            "rng_key was provided; falling back to greedy decoding")
        return 0.0, 0, None
    return request.temperature, request.top_k, key


def raw_key_data(key) -> np.ndarray:
    """A PRNG key (tensor, array or sequence of two words) as host
    uint32[2], the (B, 2)-stackable form the per-row sampler consumes."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    return (np.asarray(key, np.int64) & _MASK).astype(np.uint32)


def sample_token(logits: torch.Tensor, key=None, *, temperature=0.0,
                 top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32. ``temperature <= 0`` is greedy
    (argmax, first maximum). ``temperature > 0`` draws from the
    (optionally top-k truncated; ``top_k`` clipped to V) categorical with
    ``key``; without a key it falls back to greedy with a warning. A 0-d
    tensor ``temperature`` (a compiled decode's input) is taken as > 0 and
    needs ``key``: nothing reads it on the host."""
    if isinstance(temperature, torch.Tensor):
        assert key is not None, "a tensor temperature needs a PRNG key"
        t = temperature.to(device=logits.device, dtype=torch.float32)
    else:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if key is None:
            warnings.warn("sample_token: temperature > 0 but no PRNG key "
                          "was provided; falling back to greedy decoding")
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # an f32 tensor on the logits' device: CUDA turns division by a
        # host scalar into a multiply by its reciprocal, which is not the
        # CPU's (and jax's) rounding, and not ``sample_token_rows``'
        t = torch.full((), float(temperature), dtype=torch.float32,
                       device=logits.device)
    logits = logits / t
    if top_k:
        vals = torch.topk(logits, min(top_k, logits.shape[-1]), dim=-1).values
        logits = torch.where(logits >= vals[..., -1:], logits,
                             torch.full_like(logits, -float("inf")))
    return categorical(_words(key).to(logits.device), logits).to(torch.int32)


def sample_token_rows(logits: torch.Tensor, keys: torch.Tensor,
                      temperatures: torch.Tensor, top_ks: torch.Tensor
                      ) -> torch.Tensor:
    """Per-row sampling over the whole batch at once: logits (B, V), keys
    (B, 2), temperatures (B,) f32, top_ks (B,) int -> (B,) int32.

    Row i equals ``sample_token(logits[i:i+1], keys[i],
    temperature=temperatures[i], top_k=top_ks[i])``: each row draws its
    (1, V) Gumbels from its own key, and its top-k threshold is the k-th
    largest scaled logit from a descending sort (k clipped to [0, V]; 0
    keeps every logit). Rows with ``temperature <= 0`` take the greedy
    argmax. Only tensor ops with fixed shapes: nothing syncs the host."""
    b, v = logits.shape
    t = temperatures.to(torch.float32)
    sampled = t > 0.0
    scaled = logits / torch.where(sampled, t, torch.ones_like(t))[:, None]
    kk = torch.clamp(top_ks.to(torch.int64), 0, v)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(kk - 1, min=0)[:, None])
    thresh = torch.where(kk[:, None] > 0, kth,
                         torch.full_like(kth, -float("inf")))
    masked = torch.where(scaled >= thresh, scaled,
                         torch.full_like(scaled, -float("inf")))
    g = gumbel(keys, (1, v)).reshape(b, v)
    samp = torch.argmax(g + masked, dim=-1)
    return torch.where(sampled, samp,
                       torch.argmax(logits, dim=-1)).to(torch.int32)
