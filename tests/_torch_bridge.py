"""Helpers the port's parity tests share: make the JAX package's params
from numpy, and bring JAX-package objects across to ``repro_torch`` as
numpy, the way a user of ``repro_torch.params`` would.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.quant.qtensor import MixedPrecisionWeights as JMixed
from repro.quant.qtensor import QuantizedTensor as JQT
from repro_torch.models.config import DyMoEPolicy as TPolicy
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.params import from_reference


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
