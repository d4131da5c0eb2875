"""Port parity for the dense packed matmul (K3): the plain PyTorch version
behind ``repro_torch.kernels.quant_matmul`` against the JAX package's
``quant_matmul`` through its jnp oracle (f32 allclose at atol = rtol =
1e-5: the sums run in another order) and through the Pallas kernel in
interpret mode (atol 5e-4, rtol 1e-4, the tolerance of the JAX package's
own kernel test), over bits 2/4/8 and M 1/8/32. The CUDA kernel itself
runs only on a GPU: it is held against this plain version in
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import n, port, t
from repro.kernels.quant_matmul.ops import quant_matmul as jquant_matmul
from repro.quant import QuantizedTensor as JQT
from repro_torch.kernels import quant_matmul
from repro_torch.kernels.quant_matmul import quant_matmul as kmod

K, N, GROUP = 128, 32, 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _qt(bits, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    return JQT.quantize(jnp.asarray(w), bits, GROUP)


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plain_matches_pallas_and_ref(bits, m):
    qt = _qt(bits, seed=bits)
    x = np.random.default_rng(10 + m).standard_normal((m, K)).astype(
        np.float32)
    kw = dict(out_dtype=jnp.float32)
    ref = np.asarray(jquant_matmul(jnp.asarray(x), qt, impl="ref", **kw))
    pal = np.asarray(jquant_matmul(jnp.asarray(x), qt, impl="pallas",
                                   interpret=True, block_m=min(8, m),
                                   block_n=16, block_k=64, **kw))
    got = n(quant_matmul(t(x), port(qt), out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leading_dims_reshape_and_out_dtype(dtype):
    """x (..., K) -> (..., N) as in the JAX package, in both x dtypes; the
    bf16 output is the f32 result rounded."""
    qt = _qt(4, seed=5)
    x = np.random.default_rng(5).standard_normal((2, 3, K)).astype(
        np.float32)
    jx = jnp.asarray(x, dtype)
    tx = t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    ref = np.asarray(jquant_matmul(jx, qt, impl="ref",
                                   out_dtype=jnp.float32))
    got32 = quant_matmul(tx, port(qt), out_dtype=torch.float32)
    got = quant_matmul(tx, port(qt))
    assert got32.shape == (2, 3, N) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got32), ref, **TOL)
    assert torch.equal(got, got32.to(torch.bfloat16))


def test_cpu_tensor_never_launches():
    kmod.reset_launch_counts()
    quant_matmul(torch.zeros((4, K)), port(_qt(2)))
    assert kmod.LAUNCHES == {"quant_matmul": 0}
