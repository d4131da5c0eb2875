"""The port's CUDA kernels on the card: K1, K2 and K3, built from
``src/repro_torch/kernels/quant_matmul/csrc``, and K4 and K5, built from
``src/repro_torch/kernels/attn_scores/csrc``, against their plain PyTorch
versions on the same CUDA inputs, at ragged shapes (S and M not multiples
of a tile). (The engine's greedy tokens on the card
against the plain path on the CPU are checked by ``chip_smoke.py``'s
reference phase.) Imports no JAX, so it runs where the card is:
``python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Every test skips (and says why) where there is no GPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_with_scores
from repro_torch.kernels.attn_scores import attn_scores as amod
from repro_torch.kernels.quant_matmul import expert_quant_matmul as kmod
from repro_torch.kernels.quant_matmul import quant_matmul as dmod
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor

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



@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 45])         # 45: not a multiple of BM
def test_cuda_quant_matmul_matches_plain(bits, m):
    """K3, bf16 x: f32 out within 5e-4·(1 + |ref|) of the plain version
    (K summed in another order), bf16 out exactly the f32 out rounded."""
    dev = _need_cuda()
    rng = np.random.default_rng(bits * 100 + m)
    w = torch.from_numpy(rng.standard_normal((256, 200)).astype(
        np.float32)).to(dev) * 256 ** -0.5
    qt = QuantizedTensor.quantize(w, bits, 64)
    x = torch.from_numpy(rng.standard_normal((m, 256)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kw = dict(bits=bits, group_size=64)
    before = dmod.LAUNCHES["quant_matmul"]
    got32 = dmod.quant_matmul_cuda(x, qt.packed, qt.scales,
                                   out_dtype=torch.float32, **kw)
    got = dmod.quant_matmul_cuda(x, qt.packed, qt.scales, **kw)
    torch.cuda.synchronize()
    ref = dmod.PLAIN["quant_matmul"](x, qt.packed, qt.scales,
                                     out_dtype=torch.float32, **kw)
    assert torch.all((got32 - ref).abs() <= 5e-4 * (1 + ref.abs()))
    assert torch.equal(got, got32.to(torch.bfloat16))
    assert dmod.LAUNCHES["quant_matmul"] == before + 2


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(1, 8), (77, 40), (200, 128), (70, 256)])
def test_cuda_attn_scores_match_plain(causal, dtype, s, d):
    """K4 out and lse, K5 mass: |Δ| <= 1e-4·(1 + |ref|) against the plain
    versions (f32 sums in another order); masses sum to S per head."""
    dev = _need_cuda()
    rng = np.random.default_rng(s * 1000 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    before = dict(amod.LAUNCHES)
    out, lse = amod.flash_fwd_cuda(q, k, v, causal=causal)
    mass = amod.key_mass_cuda(q, k, lse, causal=causal)
    _, imp = flash_attention_with_scores(q, k, v, causal=causal)
    torch.cuda.synchronize()
    rout, rlse = amod.PLAIN["flash_fwd"](q, k, v, causal=causal)
    rmass = amod.PLAIN["key_mass"](q, k, rlse, causal=causal)
    for got, ref in ((out, rout), (lse, rlse), (mass, rmass),
                     (imp, rmass.mean(0))):
        assert torch.all((got - ref).abs() <= 1e-4 * (1 + ref.abs())), \
            (got - ref).abs().max().item()
    assert torch.allclose(mass.sum(1), torch.full((3,), float(s),
                                                  device=dev), rtol=1e-5)
    assert amod.LAUNCHES == {"flash_fwd": before["flash_fwd"] + 2,
                             "key_mass": before["key_mass"] + 2}


def test_cuda_new_wrappers_refuse_bad_inputs():
    dev = _need_cuda()
    qt = QuantizedTensor.quantize(torch.randn(64, 32, device=dev), 4, 64)
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(ValueError):            # f16 activations
        dmod.quant_matmul_cuda(x.half(), qt.packed, qt.scales, bits=4,
                               group_size=64)
    with pytest.raises(ValueError):            # CPU tensor
        dmod.quant_matmul_cuda(x.cpu(), qt.packed, qt.scales, bits=4,
                               group_size=64)
    with pytest.raises(ValueError):            # K does not match the codes
        dmod.quant_matmul_cuda(x[:, :48].contiguous(), qt.packed, qt.scales,
                               bits=4, group_size=16)
    q = torch.randn(2, 16, 32, device=dev)
    with pytest.raises(ValueError):            # f16
        amod.flash_fwd_cuda(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):            # CPU tensor
        amod.flash_fwd_cuda(q.cpu(), q.cpu(), q.cpu())
    with pytest.raises(ValueError):            # D above 256
        big = torch.randn(1, 4, 300, device=dev)
        amod.flash_fwd_cuda(big, big, big)
    with pytest.raises(ValueError):            # k of another shape
        amod.flash_fwd_cuda(q, q[:, :8].contiguous(), q)
    with pytest.raises(ValueError):            # lse of another shape
        amod.key_mass_cuda(q, q, torch.zeros(2, 8, device=dev))
