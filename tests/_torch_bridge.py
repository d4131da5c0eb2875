"""Helpers the port's parity tests share: make the JAX package's params
from numpy, and bring JAX-package objects across to ``repro_torch`` as
numpy, the way a user of ``repro_torch.params`` would.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.kv_cache import KVCache as JKVCache
from repro.quant.qtensor import MixedPrecisionWeights as JMixed
from repro.quant.qtensor import QuantizedTensor as JQT
from repro_torch.models.config import DyMoEPolicy as TPolicy
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.kv_cache import KVCache, SSMCache
from repro_torch.models.model import quantize_model
from repro_torch.params import from_reference
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor

# The parity tests run small shapes, several pytest-xdist workers to a
# machine: torch's intra-op pool (a thread a core in every worker) would
# oversubscribe the cores several times over, so torch runs one thread in
# each process that imports these helpers.
torch.set_num_threads(1)


def to_numpy_tree(tree):
    """JAX params / qparams -> nested dicts of numpy arrays, with
    QuantizedTensor as {packed, scales, bits, group_size, k} and
    MixedPrecisionWeights as {high, low}."""
    if isinstance(tree, JMixed):
        return {"high": to_numpy_tree(tree.high),
                "low": None if tree.low is None else to_numpy_tree(tree.low)}
    if isinstance(tree, JQT):
        return {"packed": np.asarray(tree.packed),
                "scales": np.asarray(tree.scales), "bits": tree.bits,
                "group_size": tree.group_size, "k": tree.k}
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port(tree):
    """A JAX tree as the port's tree on the CPU."""
    return from_reference(to_numpy_tree(tree), "cpu")


def to_jax(tree):
    """The port's tree (params, or a packed store as ``quantize_model``
    makes it) as the JAX package's, from numpy."""
    if isinstance(tree, MixedPrecisionWeights):
        return JMixed(high=to_jax(tree.high),
                      low=None if tree.low is None else to_jax(tree.low))
    if isinstance(tree, QuantizedTensor):
        return JQT(packed=jnp.asarray(n(tree.packed)),
                   scales=jnp.asarray(n(tree.scales)), bits=tree.bits,
                   group_size=tree.group_size, k=tree.k)
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(n(tree))


def quantized_pair(params, cfg):
    """One packed store of JAX-made ``params`` for both packages: the
    port's ``quantize_model`` (bitwise the reference's eager run,
    ``tests/test_torch_quant.py``; a fraction of the eager run's time),
    and the same codes as a JAX tree. Returns (JAX qparams, port's)."""
    tq = quantize_model(port(params), port_cfg(cfg))
    return to_jax(tq), tq


def port_cfg(cfg):
    """The port's ModelConfig equal field for field to a JAX one."""
    d = dataclasses.asdict(cfg)
    d["dymoe"] = TPolicy(**d["dymoe"])
    return TConfig(**d)


def numpy_init(init, seed=0):
    """The tree ``init()`` returns, as JAX arrays drawn by numpy from
    ``seed``: norm scales 1 + 0.1·N(0, 1), the embedding N(0, 1/d), every
    other weight N(0, 1/fan_in) with fan_in its next-to-last dim. Only
    shapes are traced (``jax.eval_shape``), so no initializer is compiled.
    """
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        key = path[-1].key
        if key == "scale":
            v = 1 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            fan_in = leaf.shape[-1 if key == "embed" else -2]
            v = rng.standard_normal(leaf.shape) * fan_in ** -0.5
        return jnp.asarray(v, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init))


def jit_run(fn):
    """``fn()`` under one ``jax.jit``, as the JAX package's serving path
    runs its programs: one compile, not one per eagerly run op."""
    return jax.jit(fn)()


def t(a, dtype=None):
    """numpy (or JAX) array -> CPU tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def n(x):
    """tensor -> numpy."""
    return x.detach().cpu().numpy()


def port_cache(c):
    """A JAX KVCache or SSMCache as the port's on the CPU, a KVCache's
    ``ring`` flag included."""
    if isinstance(c, JKVCache):
        return KVCache(k=t(c.k), v=t(c.v), positions=t(c.positions),
                       length=t(c.length), offset=t(c.offset), ring=c.ring)
    return SSMCache(conv_state=t(c.conv_state), ssm_state=t(c.ssm_state),
                    length=t(c.length))


def port_caches(caches):
    """JAX caches ({"layers": KVCache or SSMCache, "shared": the hybrid's
    site stack}) as the port's (:func:`port_cache`)."""
    return {part: port_cache(c) for part, c in caches.items()}
