"""Port parity for the packed-expert matmuls: the plain PyTorch versions
of K1 (grouped, watermarked) and K2 (critical-masked) against the JAX
package's Pallas kernels in interpret mode and its jnp oracles, in "4/2"
and "4/0", with random ragged watermarks and M/N that are not multiples
of the blocks. f32 allclose at atol = rtol = 1e-5 (sums run in another
order); dead rows exactly zero. The CUDA kernels themselves run only on
a GPU: they are held against these plain versions in
``tests/test_torch_cuda.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import n, port, t
from repro.kernels.quant_matmul.ops import expert_quant_matmul as jeqm
from repro.kernels.quant_matmul.ops import \
    expert_quant_matmul_grouped as jeqm_grouped
from repro.quant import MixedPrecisionWeights as JMixed
from repro_torch.kernels.quant_matmul import expert_quant_matmul as kmod
from repro_torch.kernels.quant_matmul.ops import expert_quant_matmul, \
    expert_quant_matmul_grouped

E, K, N = 4, 64, 40          # N=40: not a multiple of block_n=16 or BN=64
GROUP = 32
TOL = dict(atol=1e-5, rtol=1e-5)


def _weights(hi, lo, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    return JMixed.build(jnp.asarray(w), hi, lo, GROUP)


def _ragged_x(cap, has_lo, seed):
    """Combined buffer with slots past random watermarks zero-filled (the
    dispatch invariant); counts include 0 and full."""
    rng = np.random.default_rng(seed)
    m = 2 * cap if has_lo else cap
    x = rng.standard_normal((E, m, K)).astype(np.float32)
    counts = rng.integers(0, cap + 1, size=(E, 2)).astype(np.int32)
    counts[0, 0], counts[1, 0] = 0, cap
    if not has_lo:
        counts[:, 1] = 0
    for e in range(E):
        x[e, counts[e, 0]:cap] = 0.0
        if has_lo:
            x[e, cap + counts[e, 1]:] = 0.0
    return x, counts


@pytest.mark.parametrize("hi,lo", [(4, 2), (4, None), (8, 4)])
@pytest.mark.parametrize("cap", [3, 7])      # 7: not a block_m multiple
def test_grouped_plain_matches_pallas_and_ref(hi, lo, cap):
    mp = _weights(hi, lo, seed=cap)
    x, counts = _ragged_x(cap, lo is not None, seed=10 + cap)
    kw = dict(cap_hi=cap, out_dtype=jnp.float32)
    pal = np.asarray(jeqm_grouped(
        jnp.asarray(x), mp, jnp.asarray(counts), impl="pallas",
        interpret=True, block_m=4, block_n=16, block_k=32, **kw))
    ref = np.asarray(jeqm_grouped(jnp.asarray(x), mp, impl="ref", **kw))
    got = n(expert_quant_matmul_grouped(t(x), port(mp), t(counts),
                                        cap_hi=cap, out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, atol=5e-4, rtol=1e-4)
    for e in range(E):                      # dead slots: exact zero
        assert not np.any(got[e, counts[e, 0]:cap])
        if lo is not None:
            assert not np.any(got[e, cap + counts[e, 1]:])


def test_grouped_plain_zeroes_dead_rows_of_nonzero_input():
    """The plain version is the kernel's function: rows past a watermark
    come back zero even when the buffer holds garbage there."""
    mp = port(_weights(4, 2, seed=3))
    x = torch.ones((E, 10, K))
    counts = torch.tensor([[0, 5], [5, 0], [2, 3], [5, 5]], dtype=torch.int32)
    y = expert_quant_matmul_grouped(x, mp, counts, cap_hi=5,
                                    out_dtype=torch.float32)
    for e in range(E):
        c_hi, c_lo = counts[e].tolist()
        assert not y[e, c_hi:5].any() and not y[e, 5 + c_lo:].any()
        assert (c_hi == 0 or y[e, :c_hi].abs().sum() > 0) and \
            (c_lo == 0 or y[e, 5:5 + c_lo].abs().sum() > 0)


@pytest.mark.parametrize("hi,lo", [(4, 2), (4, None), (2, 2)])
@pytest.mark.parametrize("m", [5, 16])
def test_expert_plain_matches_pallas_and_ref(hi, lo, m):
    mp = _weights(hi, lo, seed=m)
    rng = np.random.default_rng(20 + m)
    x = rng.standard_normal((E, m, K)).astype(np.float32)
    crit = np.array([1, 0, 1, 0], np.int32)
    kw = dict(out_dtype=jnp.float32)
    pal = np.asarray(jeqm(jnp.asarray(x), mp, jnp.asarray(crit),
                          impl="pallas", interpret=True, block_m=4,
                          block_n=16, block_k=32, **kw))
    ref = np.asarray(jeqm(jnp.asarray(x), mp, jnp.asarray(crit), impl="ref",
                          **kw))
    got = n(expert_quant_matmul(t(x), port(mp), t(crit),
                                out_dtype=torch.float32))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, pal, atol=5e-4, rtol=1e-4)
    if lo is None:                           # "4/0": sub-critical is zero
        assert not np.any(got[crit == 0])


def test_cpu_tensor_never_launches():
    """A CPU tensor runs the plain version and counts no launch."""
    kmod.reset_launch_counts()
    mp = port(_weights(4, 2))
    expert_quant_matmul_grouped(torch.zeros((E, 4, K)), mp, cap_hi=2)
    expert_quant_matmul(torch.zeros((E, 4, K)), mp,
                        torch.ones(E, dtype=torch.int32))
    assert kmod.LAUNCHES == {"expert_quant_matmul_grouped": 0,
                             "expert_quant_matmul": 0}

