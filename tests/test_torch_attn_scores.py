"""Port parity for attention with per-key mass (K4 + K5): the plain
PyTorch versions behind ``repro_torch.kernels.flash_attention_with_scores``
against the JAX package's Pallas kernels in interpret mode (out, lse and
mass at atol 1e-4, the tolerance of its own kernel test) and its jnp
oracle (atol = rtol = 1e-5), causal and not; and the op's mass against the
Eq. 1 importance the model computes in ``attention_train``. The CUDA
kernels themselves run only on a GPU: they are held against these plain
versions in ``tests/test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import jit_run, n, numpy_init, port, port_cfg, t
from repro.configs import get_config as jget_config
from repro.kernels.attn_scores.attn_scores import flash_fwd_pallas, \
    key_mass_pallas
from repro.kernels.attn_scores.ops import \
    flash_attention_with_scores as jflash
from repro.models.layers import attention as jattn
from repro_torch.kernels import flash_attention_with_scores
from repro_torch.kernels.attn_scores import attn_scores as kmod
from repro_torch.kernels.attn_scores import ref
from repro_torch.models.layers import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,s,d", [(2, 32, 16), (4, 64, 32)])
def test_plain_passes_match_pallas(causal, h, s, d):
    q, k, v = _qkv(h, s, d, seed=h * s + d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, jlse = flash_fwd_pallas(jq, jk, jv, causal=causal, block_q=16,
                                  block_k=16, interpret=True)
    jmass = key_mass_pallas(jq, jk, jlse, causal=causal, block_q=16,
                            block_k=16, interpret=True)
    out, lse = ref.flash_fwd_ref(t(q), t(k), t(v), causal=causal)
    mass = ref.key_mass_ref(t(q), t(k), lse, causal=causal)
    for got, want in ((out, jout), (lse, jlse), (mass, jmass)):
        np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_op_matches_jax_oracle(causal):
    """The port's op (plain K4 + K5 on the CPU) and its oracle twin equal
    the JAX op's jnp oracle; each head's masses sum to S."""
    h, s, d = 3, 40, 16                # S not a multiple of any tile
    q, k, v = _qkv(h, s, d, seed=3)
    jout, jimp = jflash(*map(jnp.asarray, (q, k, v)), causal=causal,
                        impl="ref")
    out, imp = flash_attention_with_scores(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(n(out), np.asarray(jout), **TOL)
    np.testing.assert_allclose(n(imp), np.asarray(jimp), **TOL)
    oout, omass = ref.attention_with_scores_ref(t(q), t(k), t(v),
                                                causal=causal)
    np.testing.assert_allclose(n(oout), np.asarray(jout), **TOL)
    np.testing.assert_allclose(n(omass.mean(0)), np.asarray(jimp), **TOL)
    _, lse = ref.flash_fwd_ref(t(q), t(k), t(v), causal=causal)
    mass = ref.key_mass_ref(t(q), t(k), lse, causal=causal)
    np.testing.assert_allclose(n(mass.sum(1)), np.full(h, s), rtol=1e-5)
    assert (n(mass) >= 0).all()


def test_mass_is_the_models_eq1_importance():
    """On the reduced OLMoE, one unpadded row: the op's mass over the
    port's q/k/v equals the JAX ``attention_train`` importance."""
    cfg = jget_config("olmoe_1b_7b").reduced()
    p = numpy_init(lambda: jattn.init_attention(
        cfg, jax.random.PRNGKey(4), jnp.float32), 4)
    s = 32
    x = np.random.default_rng(6).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    _, jimp, _ = jit_run(lambda: jattn.attention_train(
        p, cfg, jnp.asarray(x), want_token_importance=True))
    pos = torch.arange(s, dtype=torch.int32)[None]
    q, k, v = tattn._project_qkv(port(p), port_cfg(cfg), t(x), pos)
    h = cfg.num_heads
    _, imp = flash_attention_with_scores(q[0].reshape(h, s, -1), k[0], v[0])
    np.testing.assert_allclose(n(imp), np.asarray(jimp[0]), atol=1e-5)


def test_cpu_tensor_never_launches():
    kmod.reset_launch_counts()
    q, k, v = (t(a) for a in _qkv(2, 8, 4, seed=1))
    flash_attention_with_scores(q, k, v)
    assert kmod.LAUNCHES == {"flash_fwd": 0, "key_mass": 0}
