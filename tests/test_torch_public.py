"""Port parity for the small public functions of ``repro.core`` and
``repro.quant``, and for the public names of every subpackage.

* ``decode_expert_importance`` (Eq. 3) and ``select_mixed_weights`` (the
  materializing precision select, "x/0" with ``skip_to_zero`` both ways):
  bitwise the JAX package's;
* ``layer_similarity`` (paper Fig. 6) and ``mixed_precision_matmul(...,
  materialize=True)``: allclose at f32 (1e-5);
* ``gptq_lite_quantize``: codes and scales bitwise the reference run op by
  op (``jax.disable_jit()``); against its jitted run (XLA rewrites the
  division there) the codes are equal and the scales within rtol 1e-6;
* every name in the ``__all__`` of ``repro.core``, ``repro.quant``,
  ``repro.models``, ``repro.serving``, ``repro.kernels``,
  ``repro.analysis``, ``repro.roofline`` and ``repro.configs`` exists in
  the port's subpackage, except the names of ``NOT_PORTED``, each with
  the ROADMAP item that ports it, and the Pallas- and jaxpr-only names of
  ``HEIRS``, each with the name of the port that takes its place."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import n, port, t
from repro.core import decode_expert_importance as jdecode_importance
from repro.core.prefetch import layer_similarity as jlayer_similarity
from repro.quant import MixedPrecisionWeights as JMixed
from repro.quant import gptq_lite_quantize as jgptq
from repro.quant import mixed_precision_matmul as jmixed_matmul
from repro.quant import select_mixed_weights as jselect
from repro_torch.core import decode_expert_importance, layer_similarity
from repro_torch.quant import MixedPrecisionWeights, QuantizedTensor, \
    gptq_lite_quantize, mixed_precision_matmul, select_mixed_weights

TOL = dict(atol=1e-5, rtol=1e-5)

# reference names the port does not have yet -> the ROADMAP item porting it
NOT_PORTED = {}

# names of a jaxpr or of a Pallas kernel -> the port's name in their place
HEIRS = {"analysis": {
    "EqnSite": "OpSite", "iter_eqns": "iter_ops", "find_eqns": "find_ops",
    "subjaxprs": "trace_ops", "intermediate_avals": "intermediate_shapes",
    "count_primitive": "count_op", "count_pallas_calls": "count_kernel_calls",
    "PallasVmemEstimate": "KernelResources",
    "VMEM_BUDGET_BYTES": "SMEM_BUDGET_BYTES",
    "estimate_pallas_vmem": "launch_smem_bytes"}}


@pytest.mark.parametrize("pkg", ["core", "quant", "models", "serving",
                                 "kernels", "analysis", "roofline",
                                 "configs"])
def test_public_names_exist(pkg):
    ref = importlib.import_module(f"repro.{pkg}")
    mine = importlib.import_module(f"repro_torch.{pkg}")
    heirs = HEIRS.get(pkg, {})
    missing = {name for name in ref.__all__ if not hasattr(mine, name)}
    assert missing == set(NOT_PORTED.get(pkg, {})) | set(heirs), missing
    assert set(ref.__all__) - set(mine.__all__) == missing
    assert set(heirs.values()) <= set(mine.__all__)


def test_decode_expert_importance_is_the_gate():
    g = np.random.default_rng(0).random(16).astype(np.float32)
    np.testing.assert_array_equal(n(decode_expert_importance(t(g))),
                                  np.asarray(jdecode_importance(
                                      jnp.asarray(g))))


def test_layer_similarity_matches():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 5, 64)).astype(np.float32)
    b = (a + 0.3 * rng.standard_normal(a.shape)).astype(np.float32)
    for x, y in ((a, b), (a, a), (a, -a)):
        np.testing.assert_allclose(
            n(layer_similarity(t(x), t(y))),
            np.asarray(jlayer_similarity(jnp.asarray(x), jnp.asarray(y))),
            **TOL)


@functools.lru_cache(maxsize=None)
def _mixed(batched, low_bits):
    """One weight's packed store, expert-batched (E, K, N) or dense (K, N),
    made by the JAX package (one jit) and brought across to the port."""
    shape = (3, 128, 32) if batched else (128, 32)
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jmp = jax.jit(lambda x: JMixed.build(x, high_bits=4, low_bits=low_bits,
                                         group_size=64))(jnp.asarray(w))
    return jmp, port(jmp)


@pytest.mark.parametrize("batched,low_bits,skip", [
    (True, 2, True), (True, 0, True), (True, 0, False), (False, 2, True),
    (False, 0, True), (False, 0, False)])
def test_select_and_materialized_matmul_match(batched, low_bits, skip):
    jmp, mp = _mixed(batched, low_bits or None)
    crit = np.array([True, False, True]) if batched else np.bool_(False)
    got = select_mixed_weights(mp, t(crit), torch.float32, skip_to_zero=skip)
    want = jselect(jmp, jnp.asarray(crit), jnp.float32, skip_to_zero=skip)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    x = np.random.default_rng(3).standard_normal(
        (3, 5, 128) if batched else (2, 4, 128)).astype(np.float32)
    y = mixed_precision_matmul(t(x), mp, t(crit), skip_to_zero=skip,
                               materialize=True)
    jy = jmixed_matmul(jnp.asarray(x), jmp, jnp.asarray(crit),
                       skip_to_zero=skip, materialize=True)
    assert y.dtype == torch.float32 and y.shape == tuple(jy.shape)
    np.testing.assert_allclose(n(y), np.asarray(jy), **TOL)
    # the kernel path computes the same product from the packed codes
    np.testing.assert_allclose(
        n(mixed_precision_matmul(t(x), mp, t(crit), skip_to_zero=skip)),
        n(y), **TOL)
    assert isinstance(mp, MixedPrecisionWeights)
    assert isinstance(mp.high, QuantizedTensor)


def test_gptq_lite_quantize_matches():
    """2-bit codes, groups of 32, two stacked matrices, a 3-point grid."""
    shape, bits, gs, n_iter = (2, 128, 24), 2, 32, 3
    w = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    q, s = gptq_lite_quantize(t(w), bits, gs, n_iter=n_iter)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    with jax.disable_jit():
        jq, js = jgptq(jnp.asarray(w), bits, gs, n_iter=n_iter)
    np.testing.assert_array_equal(n(q), np.asarray(jq))
    np.testing.assert_array_equal(n(s), np.asarray(js))
    jq, js = jgptq(jnp.asarray(w), bits, gs, n_iter=n_iter)
    np.testing.assert_array_equal(n(q), np.asarray(jq))
    np.testing.assert_allclose(n(s), np.asarray(js), rtol=1e-6, atol=0)
