"""The port's CUDA kernels on the card: K1 and K2, built from
``src/repro_torch/kernels/quant_matmul/csrc``, against their plain PyTorch
versions on the same CUDA inputs. (The engine's greedy tokens on the card
against the plain path on the CPU are checked by ``chip_smoke.py``'s
reference phase.) Imports no JAX, so it runs where the card is:
``python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Every test skips (and says why) where there is no GPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quant_matmul import expert_quant_matmul as kmod
from repro_torch.quant.qtensor import MixedPrecisionWeights

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("lo", [2, None], ids=["4/2", "4/0"])
def test_cuda_kernels_match_plain(lo):
    """bf16 activations, f32 out: |Δ| <= 5e-4·(1 + |ref|) (the kernel sums
    K in another order than the library matmul); dead rows exactly 0."""
    dev = _need_cuda()
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((8, 256, 200)).astype(
        np.float32)).to(dev) * 256 ** -0.5
    mp = MixedPrecisionWeights.build(w, 4, lo, 64)
    cap = 37                                  # not a multiple of BM
    m = 2 * cap if lo else cap
    x = torch.from_numpy(rng.standard_normal((8, m, 256)).astype(
        np.float32)).to(dev, torch.bfloat16)
    counts = torch.from_numpy(rng.integers(0, cap + 1, (8, 2)).astype(
        np.int32)).to(dev)
    counts[0, 0], counts[1, 0] = 0, cap
    crit = torch.from_numpy((rng.random(8) < 0.5).astype(np.int32)).to(dev)
    lo_p = mp.low.packed if lo else None
    lo_s = mp.low.scales if lo else None
    kw = dict(hi_bits=4, lo_bits=lo or 0, group_size=64,
              out_dtype=torch.float32)
    before = dict(kmod.LAUNCHES)
    k1 = kmod.expert_quant_matmul_grouped_cuda(
        x, mp.high.packed, mp.high.scales, lo_p, lo_s, counts, cap_hi=cap,
        **kw)
    k2 = kmod.expert_quant_matmul_cuda(
        x, mp.high.packed, mp.high.scales, lo_p, lo_s, crit, **kw)
    torch.cuda.synchronize()
    r1 = kmod.PLAIN["expert_quant_matmul_grouped"](
        x, mp.high.packed, mp.high.scales, lo_p, lo_s, counts, cap_hi=cap,
        **kw)
    r2 = kmod.PLAIN["expert_quant_matmul"](
        x, mp.high.packed, mp.high.scales, lo_p, lo_s, crit, **kw)
    for got, ref in ((k1, r1), (k2, r2)):
        assert torch.all((got - ref).abs() <= 5e-4 * (1 + ref.abs()))
    cnt = counts.cpu()
    for e in range(8):
        assert not k1[e, cnt[e, 0]:cap].any()
        if lo:
            assert not k1[e, cap + cnt[e, 1]:].any()
    assert kmod.LAUNCHES["expert_quant_matmul_grouped"] == \
        before["expert_quant_matmul_grouped"] + 1
    assert kmod.LAUNCHES["expert_quant_matmul"] == \
        before["expert_quant_matmul"] + 1


def test_cuda_wrappers_refuse_bad_inputs():
    dev = _need_cuda()
    w = torch.randn(2, 64, 32, device=dev)
    mp = MixedPrecisionWeights.build(w, 4, 2, 64)
    x = torch.randn(2, 4, 64, device=dev)
    with pytest.raises(ValueError):            # int64 watermarks
        kmod.expert_quant_matmul_grouped_cuda(
            x, mp.high.packed, mp.high.scales, mp.low.packed, mp.low.scales,
            torch.zeros((2, 2), dtype=torch.int64, device=dev), cap_hi=2,
            hi_bits=4, lo_bits=2, group_size=64)
    with pytest.raises(ValueError):            # CPU tensor
        kmod.expert_quant_matmul_cuda(
            x.cpu(), mp.high.packed, mp.high.scales, None, None,
            torch.ones(2, dtype=torch.int32, device=dev), hi_bits=4,
            lo_bits=0, group_size=64)

