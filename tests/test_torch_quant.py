"""Port parity: bit-packing, RTN quantization and ``quantize_model`` of
``repro_torch`` against the JAX package — bitwise (packed codes and
scales must match exactly)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import n, numpy_init, port, port_cfg, t
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import quantize_model as jquantize_model
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.quant.packing import pack_bits as jpack_bits
from repro.quant.quantize import quantize_tensor as jquantize_tensor
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.model import quantize_model
from repro_torch.quant.packing import pack_bits, unpack_bits
from repro_torch.quant.quantize import dequantize_tensor, quantize_tensor


def _tiny_moe(low_bits):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_unpack_bitwise(bits):
    rng = np.random.default_rng(bits)
    lo = -(1 << (bits - 1))
    v = rng.integers(lo, -lo, size=(3, 5, 32)).astype(np.int8)
    got = n(pack_bits(t(v), bits))
    np.testing.assert_array_equal(got, np.asarray(jpack_bits(jnp.asarray(v),
                                                             bits)))
    np.testing.assert_array_equal(n(unpack_bits(t(got), bits)), v)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("group", [16, 64])
def test_quantize_tensor_bitwise(bits, group):
    rng = np.random.default_rng(100 * bits + group)
    w = rng.standard_normal((4, 128, 48)).astype(np.float32)
    w[0, :group] = 0.0                      # an all-zero group: scale 0
    jp, js = jquantize_tensor(jnp.asarray(w), bits, group)
    tp, ts = quantize_tensor(t(w), bits, group)
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    np.testing.assert_array_equal(n(ts), np.asarray(js))
    # round trip through the port's own dequantizer stays within a step
    back = n(dequantize_tensor(tp, ts, bits, group, dtype=t(w).dtype))
    step = np.repeat(np.asarray(js), group, axis=-2)
    assert np.all(np.abs(back - w) <= step * (1 << (bits - 1)) + 1e-6)


@pytest.mark.parametrize("low_bits", [2, 0])
def test_quantize_model_bitwise(low_bits):
    cfg = _tiny_moe(low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    ref = port(jquantize_model(params, cfg))["layers"]["moe"]
    got = quantize_model(port(params), port_cfg(cfg))["layers"]["moe"]
    for name in ("w_gate", "w_up", "w_down"):
        for prec in ("high", "low"):
            r, g = getattr(ref[name], prec), getattr(got[name], prec)
            if low_bits == 0 and prec == "low":
                assert r is None and g is None
                continue
            assert (g.bits, g.group_size, g.k) == (r.bits, r.group_size, r.k)
            np.testing.assert_array_equal(n(g.packed), n(r.packed))
            np.testing.assert_array_equal(n(g.scales), n(r.scales))


@pytest.mark.parametrize("name", ARCH_IDS)
def test_configs_copied_field_for_field(name):
    j = jget_config(name)
    tc = get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(j)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(j.reduced())
