"""The port's CUDA kernels on the card: the three packed matmuls on the
tensor-core tile of ``mma_tile.cuh`` — K1 (``test_cuda_grouped_*``), K2
(``test_cuda_expert_*``) and K3 (``test_cuda_quant_matmul_*``), built from
``src/repro_torch/kernels/quant_matmul/csrc`` — and K4 and K5 on the
tensor-core score tile of ``score_tile.cuh`` (``test_cuda_attn_*``), built
from ``src/repro_torch/kernels/attn_scores/csrc``, against their plain PyTorch
versions on the same CUDA inputs, at ragged shapes (S, M and N not
multiples of a tile), with f32 and bf16 x, unaligned x, and f32 rows
spanning 2^-100 to 2^100; and the sampler's threefry bits and per-row
tokens on the card against the CPU's (``test_cuda_sampler_equals_cpu``),
and the engine's compiled decode chunk, a CUDA graph replay, against the
eager chunk (``test_cuda_compiled_chunk_equals_eager``); the open session
with a ``device.dispatch`` fault against the CPU, ``close()`` after an
unretried fault giving its decode state back, and ``generate_reference``
running K2 on decode (``test_cuda_session_*``, ``test_cuda_close_*``,
``test_cuda_generate_reference_*``).
(The engine's greedy tokens on the card
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
from repro_torch.serving import sampler

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


def _shifted(x, offset):
    """x's values in storage ``offset`` elements past a 16-byte boundary
    (0: x itself)."""
    if not offset:
        return x
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:].copy_(x.flatten())
    return buf[offset:].view(x.shape)


def _held_to_plain(mod, name, x_nan, x_zero, args, kw, dead=None,
                   row_scale=None):
    """One kernel ``name`` of wrapper module ``mod`` on ``x_nan`` at f32
    and bf16 out against its plain version on ``x_zero``: f32 out within
    5e-4·(1 + |ref|) (exact products, f32 sums in another order), bf16 out
    exactly the f32 out rounded, rows marked ``dead`` (their x rows hold
    NaN, the plain version's zeros) exactly 0, one launch per call.
    ``row_scale`` (rows,) powers of two that multiplied x's rows (axis -2):
    the tolerance is then held in each row's own units (both outputs
    divided by its scale, exactly), so a row at 2^-100 is checked as
    strictly as one at 1. Returns (f32 out, f32 ref)."""
    kernel = getattr(mod, name + "_cuda")
    before = mod.LAUNCHES[name]
    got32 = kernel(x_nan, *args, out_dtype=torch.float32, **kw)
    assert mod.LAUNCHES[name] == before + 1
    got16 = kernel(x_nan, *args, out_dtype=torch.bfloat16, **kw)
    assert mod.LAUNCHES[name] == before + 2
    torch.cuda.synchronize()
    ref = mod.PLAIN[name](x_zero, *args, out_dtype=torch.float32, **kw)
    g, r = got32, ref
    if row_scale is not None:
        rs = torch.from_numpy(row_scale).to(x_nan.device)[:, None]
        g, r = got32 / rs, ref / rs
    d = (g - r).abs()
    assert torch.all(d <= 5e-4 * (1 + r.abs())), d.max().item()
    assert torch.equal(got16, got32.to(torch.bfloat16))
    if dead is not None:
        dead_t = torch.from_numpy(dead).to(x_nan.device)
        assert torch.all(got32[dead_t] == 0) and torch.all(got16[dead_t] == 0)
    return got32, ref


def _grouped_case(dev, rng, hi, lo, cap, k, gs, x_dtype, n=200, e=4,
                  row_scale=None, x_offset=0):
    """One K1 call at f32 and bf16 out against the plain version
    (``_held_to_plain``). Expert 0 has no live hi row, expert 1 a full hi
    region (and, with a lo store, the reverse), the rest random
    watermarks. x's dead rows hold NaN: the kernel must not read them.
    ``row_scale`` (M,) powers of two multiply x's rows. ``x_offset``
    elements shift x's storage off its 16-byte alignment."""
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(
        np.float32)).to(dev) * k ** -0.5
    mp = MixedPrecisionWeights.build(w, hi, lo, gs)
    m = 2 * cap if lo else cap
    xh = rng.standard_normal((e, m, k)).astype(np.float32)
    if row_scale is not None:
        xh *= row_scale[None, :, None]
    counts_h = rng.integers(0, cap + 1, (e, 2)).astype(np.int32)
    counts_h[0] = (0, cap)
    counts_h[1] = (cap, 0)
    if not lo:
        counts_h[:, 1] = 0
    dead = np.zeros((e, m), dtype=bool)
    for i in range(e):
        dead[i, counts_h[i, 0]:cap] = True
        if lo:
            dead[i, cap + counts_h[i, 1]:] = True
    x_nan = _shifted(torch.from_numpy(np.where(dead[..., None], np.nan, xh))
                     .to(dev, x_dtype), x_offset)
    x_zero = torch.from_numpy(np.where(dead[..., None], 0.0, xh)).to(
        dev, x_dtype)
    args = (mp.high.packed, mp.high.scales, mp.low.packed if lo else None,
            mp.low.scales if lo else None, torch.from_numpy(counts_h).to(dev))
    kw = dict(cap_hi=cap, hi_bits=hi, lo_bits=lo or 0, group_size=gs)
    return _held_to_plain(kmod, "expert_quant_matmul_grouped", x_nan, x_zero,
                          args, kw, dead, row_scale)


@pytest.mark.parametrize("k,gs", [(192, 64), (256, 16), (256, 128), (80, 16)])
@pytest.mark.parametrize("cap", [1, 5, 37, 130])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("hi,lo", [(4, 2), (4, None), (8, 4), (2, 2)],
                         ids=["4/2", "4/0", "8/4", "2/2"])
def test_cuda_grouped_matches_plain(hi, lo, x_dtype, cap, k, gs):
    """K1 on the tensor cores against the plain version: f32 out within
    5e-4·(1 + |ref|) (exact products, f32 sums in another order), bf16 out
    exactly the f32 out rounded, dead rows exactly 0 though x's dead rows
    hold NaN, one launch per call. Caps ragged against the 16-row MMA tile
    and spanning more than one 64-row tile; N 200 is not a multiple of the
    128-column tile; K 80 ends in a short 16-deep chunk, and its 2- and
    4-bit code rows (20 and 40 bytes) are staged by 4-byte copies."""
    dev = _need_cuda()
    rng = np.random.default_rng(hi * 1000 + (lo or 0) * 100 + cap + k + gs)
    _grouped_case(dev, rng, hi, lo, cap, k, gs, x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
def test_cuda_grouped_unaligned_x(x_dtype):
    """x one element past a 16-byte boundary is staged by plain loads
    instead of 16-byte copies, with the same result."""
    dev = _need_cuda()
    _grouped_case(dev, np.random.default_rng(5), 4, 2, 37, 256, 64, x_dtype,
                  x_offset=1)


def test_cuda_grouped_f32_split_wide_range():
    """f32 x whose rows span 2^-100 to 2^100: the three-plane bf16 split
    keeps every product exact over the whole range (a bf16 x alone would
    miss the 5e-4 tolerance by rounding each x to 8 bits)."""
    dev = _need_cuda()
    rng = np.random.default_rng(11)
    cap, k = 37, 256
    exps = np.linspace(-100, 100, 2 * cap).round().astype(int)
    scale = np.ldexp(1.0, exps).astype(np.float32)
    got, _ = _grouped_case(dev, rng, 4, 2, cap, k, 64, torch.float32,
                           row_scale=scale)
    assert torch.isfinite(got).all()


def _expert_case(dev, rng, hi, lo, m, k, gs, x_dtype, n=200, e=4,
                 row_scale=None, x_offset=0):
    """One K2 call at f32 and bf16 out against the plain version
    (``_held_to_plain``). A random critical mask with expert 0 critical
    and expert 1 not. Under "4/0" a sub-critical expert's x rows hold NaN:
    the kernel must write its rows as zeros without reading them."""
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(
        np.float32)).to(dev) * k ** -0.5
    mp = MixedPrecisionWeights.build(w, hi, lo, gs)
    xh = rng.standard_normal((e, m, k)).astype(np.float32)
    if row_scale is not None:
        xh *= row_scale[None, :, None]
    crit_h = (rng.random(e) < 0.5).astype(np.int32)
    crit_h[:2] = (1, 0)
    dead = np.zeros((e, m), dtype=bool)
    if not lo:
        dead[crit_h == 0] = True
    x_nan = _shifted(torch.from_numpy(np.where(dead[..., None], np.nan, xh))
                     .to(dev, x_dtype), x_offset)
    x_zero = torch.from_numpy(np.where(dead[..., None], 0.0, xh)).to(
        dev, x_dtype)
    args = (mp.high.packed, mp.high.scales, mp.low.packed if lo else None,
            mp.low.scales if lo else None, torch.from_numpy(crit_h).to(dev))
    kw = dict(hi_bits=hi, lo_bits=lo or 0, group_size=gs)
    return _held_to_plain(kmod, "expert_quant_matmul", x_nan, x_zero, args,
                          kw, dead, row_scale)


@pytest.mark.parametrize("k,gs", [(192, 64), (256, 16), (256, 128), (80, 16)])
@pytest.mark.parametrize("m", [1, 10, 37, 80, 130])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("hi,lo", [(4, 2), (4, None), (8, 4), (2, 2)],
                         ids=["4/2", "4/0", "8/4", "2/2"])
def test_cuda_expert_matches_plain(hi, lo, x_dtype, m, k, gs):
    """K2 on the tensor cores against the plain version: f32 out within
    5e-4·(1 + |ref|), bf16 out exactly the f32 out rounded, under "4/0"
    sub-critical experts exactly 0 though their x rows hold NaN, one
    launch per call. M 1 and 10 run one-m16 blocks; 37 one ragged 64-row
    tile; 80 and 130 a full 64-row tile and a last tile of at most 16 rows
    (the one-m16 routine); N 200 and K 80 as in K1's cases."""
    dev = _need_cuda()
    rng = np.random.default_rng(hi * 1000 + (lo or 0) * 100 + m + k + gs)
    _expert_case(dev, rng, hi, lo, m, k, gs, x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
def test_cuda_expert_unaligned_x(x_dtype):
    """K2 with x one element past a 16-byte boundary (plain loads instead
    of 16-byte copies), under "4/0" so skipped experts are in it too."""
    dev = _need_cuda()
    _expert_case(dev, np.random.default_rng(6), 4, None, 80, 256, 64,
                 x_dtype, x_offset=1)


def test_cuda_expert_f32_split_wide_range():
    """K2 with f32 x whose rows span 2^-100 to 2^100, each checked in its
    own units: the three-plane split keeps every product exact."""
    dev = _need_cuda()
    m = 80
    scale = np.ldexp(1.0, np.linspace(-100, 100, m).round().astype(int)
                     ).astype(np.float32)
    got, _ = _expert_case(dev, np.random.default_rng(12), 4, 2, m, 256, 64,
                          torch.float32, row_scale=scale)
    assert torch.isfinite(got).all()


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


def _dense_case(dev, rng, bits, m, k, gs, x_dtype, n=200, row_scale=None,
                x_offset=0):
    """One K3 call at f32 and bf16 out against the plain version
    (``_held_to_plain``)."""
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(dev) * k ** -0.5
    qt = QuantizedTensor.quantize(w, bits, gs)
    xh = rng.standard_normal((m, k)).astype(np.float32)
    if row_scale is not None:
        xh *= row_scale[:, None]
    x = torch.from_numpy(xh).to(dev, x_dtype)
    return _held_to_plain(dmod, "quant_matmul", _shifted(x, x_offset), x,
                          (qt.packed, qt.scales),
                          dict(bits=bits, group_size=gs),
                          row_scale=row_scale)


@pytest.mark.parametrize("k,gs", [(256, 64), (80, 16)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("m", [1, 5, 16, 45, 130])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_quant_matmul_matches_plain(bits, m, x_dtype, k, gs):
    """K3 on the tensor cores: f32 out within 5e-4·(1 + |ref|) of the
    plain version (exact products, K summed in another order), bf16 out
    exactly the f32 out rounded, one launch per call. M 1, 5, 16 run
    one-m16 blocks split over K; 45 one ragged 64-row tile; 130 two full
    tiles and a 2-row tail."""
    dev = _need_cuda()
    rng = np.random.default_rng(bits * 1000 + m + k + gs)
    _dense_case(dev, rng, bits, m, k, gs, x_dtype)


@pytest.mark.parametrize("k,gs", [(1040, 16), (640, 128), (960, 48),
                                  (64, 64)])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("m", [1, 16])
def test_cuda_quant_matmul_split_k(m, x_dtype, k, gs):
    """K3 at M <= 16 splits K over a thread block cluster (N 200: two
    column tiles, so up to 8 splits): K 1040 (17 chunks, the last 16 deep)
    gives 6 splits of 3 chunks and a ragged last split of 2; gs 128 splits
    in pairs of chunks and gs 48 in threes (whole scale groups); K 64 is
    one chunk and does not split. 2-bit codes at K 1040 are 260-byte rows,
    staged by 4-byte copies. Held as every K3 case."""
    dev = _need_cuda()
    rng = np.random.default_rng(k + gs + m)
    _dense_case(dev, rng, 2 if k == 1040 else 4, m, k, gs, x_dtype)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
def test_cuda_quant_matmul_unaligned_x(x_dtype):
    """K3 with x one element past a 16-byte boundary."""
    dev = _need_cuda()
    _dense_case(dev, np.random.default_rng(8), 4, 45, 256, 64, x_dtype,
                x_offset=1)


def test_cuda_quant_matmul_f32_split_wide_range():
    """K3 with f32 x whose rows span 2^-100 to 2^100, each checked in its
    own units."""
    dev = _need_cuda()
    m = 45
    scale = np.ldexp(1.0, np.linspace(-100, 100, m).round().astype(int)
                     ).astype(np.float32)
    got, _ = _dense_case(dev, np.random.default_rng(13), 4, m, 256, 64,
                         torch.float32, row_scale=scale)
    assert torch.isfinite(got).all()


def _attn_case(dev, rng, s, d, dtype, causal, qk_scale=1.0):
    """K4 out and lse, K5 mass and the op's importance against the plain
    versions on the same inputs: |Δ| <= 1e-4·(1 + |ref|) (f32 sums in
    another order; f32 q, k, v as exact bf16 planes on the tensor cores);
    masses sum to S per head within 1e-5·S; one launch of each kernel per
    call. q and k are scaled by ``qk_scale``. Returns (q, k, v, out, lse,
    mass, reference logits)."""
    q, k, v = (torch.from_numpy(rng.standard_normal((3, s, d)).astype(
        np.float32)).to(dev) for _ in range(3))
    q, k, v = (q * qk_scale).to(dtype), (k * qk_scale).to(dtype), v.to(dtype)
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
    assert torch.all((mass.sum(1) - s).abs() <= 1e-5 * s), mass.sum(1)
    assert amod.LAUNCHES == {"flash_fwd": before["flash_fwd"] + 2,
                             "key_mass": before["key_mass"] + 2}
    logits = torch.einsum("hqd,hkd->hqk", q.float(), k.float()) * d ** -0.5
    return q, k, v, out, lse, mass, logits


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d", [(1, 8), (77, 40), (200, 128), (70, 256),
                                 (130, 33), (1000, 64), (1030, 128),
                                 (1030, 256)])
def test_cuda_attn_scores_match_plain(causal, dtype, s, d):
    """K4 and K5 against their plain versions (``_attn_case``) at ragged S
    from one tile to many key tiles past a ragged end, and every D bucket
    of the kernels (zero-padded depth at 8, 33 and 40; at odd D the rows
    are not 16-byte pieces, so the tiles are copied element-wise)."""
    dev = _need_cuda()
    _attn_case(dev, np.random.default_rng(s * 1000 + d), s, d, dtype, causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_attn_scores_large_logits(causal, dtype, d):
    """Logits up to |s| ~ 50 (q and k scaled by sqrt(11): s has std 11),
    where a two-plane split of f32 q and k (2^-16 relative) would break
    the tolerance: K4/K5 still hold 1e-4·(1 + |ref|)."""
    dev = _need_cuda()
    *_, logits = _attn_case(dev, np.random.default_rng(50 + d), 300, d,
                            dtype, causal, qk_scale=11 ** 0.5)
    assert logits.abs().max().item() >= 40


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attn_scores_deterministic(dtype):
    """Two calls give bitwise-equal out, lse and mass (fixed-order sums,
    no atomics)."""
    dev = _need_cuda()
    q, k, v, out, lse, mass, _ = _attn_case(
        dev, np.random.default_rng(5), 1030, 128, dtype, True)
    out2, lse2 = amod.flash_fwd_cuda(q, k, v, causal=True)
    mass2 = amod.key_mass_cuda(q, k, lse2, causal=True)
    torch.cuda.synchronize()
    for a, b in ((out, out2), (lse, lse2), (mass, mass2)):
        assert torch.equal(a, b)


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


def test_cuda_sampler_equals_cpu():
    """The sampler on the card against the CPU for the same keys: folded
    keys, threefry bits and uniforms bitwise (integer ops and one exact
    f32 step); Gumbels within 4 ulp of max(1, |g|): CUDA's and the CPU's
    f32 ``log`` are each within 1 ulp of the true value, so the inner
    -log(u) may differ by 2 ulp of itself (2 ulp of max(1, |g|) after
    the outer log) and the outer logs by 2 more; per-row sampled tokens
    over a 50,304-token vocabulary equal, mixed temperatures and top_k,
    and a greedy row; on the card, ``sample_token`` of row i equals row
    i of ``sample_token_rows``."""
    dev = _need_cuda()
    keys = sampler.fold_in(sampler.PRNGKey(3).expand(4, 2), torch.arange(4))
    keys_d = sampler.fold_in(sampler.PRNGKey(3).to(dev).expand(4, 2),
                             torch.arange(4, device=dev))
    assert torch.equal(keys_d.cpu(), keys)
    shape = (1, 50304)
    assert torch.equal(sampler.bits(keys_d, shape).cpu(),
                       sampler.bits(keys, shape))
    assert torch.equal(sampler.uniform(keys_d, shape).cpu(),
                       sampler.uniform(keys, shape))
    g, g_d = sampler.gumbel(keys, shape), sampler.gumbel(keys_d, shape).cpu()
    ulp = torch.from_numpy(np.spacing(np.maximum(g.abs().numpy(), 1.0)))
    assert torch.all((g_d - g).abs() <= 4 * ulp)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.standard_normal((4, 50304)) * 3).astype(
        np.float32))
    temps = torch.tensor([0.7, 0.7, 0.0, 1.3])
    topks = torch.tensor([0, 20, 0, 50304 + 5])
    want = sampler.sample_token_rows(logits, keys, temps, topks)
    got = sampler.sample_token_rows(logits.to(dev), keys_d, temps.to(dev),
                                    topks.to(dev))
    assert torch.equal(got.cpu(), want)
    assert int(want[2]) == int(torch.argmax(logits[2]))
    for i in range(4):
        solo = sampler.sample_token(logits[i:i + 1].to(dev), keys_d[i],
                                    temperature=float(temps[i]),
                                    top_k=int(topks[i]))
        assert int(solo[0]) == int(want[i])


def _chunk_equal(got, want):
    """A compiled chunk's outputs against ``decode_many_batched``'s:
    tokens, masks, done and emitted bitwise; the float telemetry too (the
    replay runs the eager chunk's kernels on the same inputs)."""
    toks, _, info, dn, emitted = want
    assert torch.equal(got.tokens, toks)
    for f in ("critical_masks", "active_masks", "gate_mean",
              "predicted_next"):
        assert torch.equal(getattr(got.info, f), getattr(info, f)), f
    assert torch.equal(got.done, dn) and torch.equal(got.n_emitted, emitted)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_cuda_compiled_chunk_equals_eager(sampled):
    """The engine's compiled decode chunk (a CUDA graph per key) on the
    reduced OLMoE against eager ``decode_many_batched`` from a copy of the
    same state: 4 slots, 2 of them dead, ``live_cap`` 2, one live row
    hitting its limit mid-chunk. The first call captures and replays; a
    second replay with the next chunk's inputs (and, sampled, new
    temperatures) equals eager again, runs clean under
    ``set_sync_debug_mode("error")`` and adds exactly the captured launch
    counts to ``LAUNCHES``; the KV caches advance as eager's do."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_many_batched, init_params, \
        prefill
    from repro_torch.serving import DyMoEEngine

    dev = _need_cuda()
    cfg = get_config("olmoe_1b_7b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = DyMoEEngine(cfg, params, device=dev)
    b, s, slots, steps = 4, 9, 40, 6
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    logits, rc, _ = prefill(eng.params, cfg, prompts, qparams=eng.qparams,
                            cache_slots=slots)
    compiled = eng._decode_batched
    state = compiled.acquire(b, slots)
    ref_caches = {"layers": dataclasses.replace(
        rc["layers"], **{f: getattr(rc["layers"], f).clone() for f in
                         ("k", "v", "positions", "length", "offset")})}
    for f in ("k", "v", "positions", "length", "offset"):
        getattr(state.caches["layers"], f).copy_(getattr(rc["layers"], f))
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    host = dict(done=np.array([False, True, False, True]),
                n_emitted=np.ones(b, np.int32),
                limits=np.array([20, 20, 4, 20], np.int32),
                eos_tokens=np.full(b, -1, np.int32))
    if sampled:
        host.update(rng_keys=np.arange(2 * b, dtype=np.int64).reshape(b, 2),
                    temperatures=np.array([0.7, 0.7, 0.0, 0.7], np.float32),
                    top_ks=np.array([0, 0, 20, 0], np.int64))

    def eager(tok, host):
        kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        return decode_many_batched(
            eng.params, cfg, tok.clone(), ref_caches, num_steps=steps,
            done=kw.pop("done"), n_emitted=kw.pop("n_emitted"),
            limits=kw.pop("limits"), eos_tokens=kw.pop("eos_tokens"),
            qparams=eng.qparams, live_cap=2, **kw)

    want = eager(tok, host)
    out = compiled(state, tok, num_steps=steps, live_cap=2, **host)
    torch.cuda.synchronize()
    _chunk_equal(out, want)
    (entry,) = state.entries.values()
    k1 = "expert_quant_matmul_grouped"
    assert entry.graph is not None
    assert entry.launches[k1] == 3 * cfg.num_layers * steps
    assert bool(out.done[2]) and not bool(out.done[0])   # limit mid-chunk
    # the next chunk, from this chunk's outputs
    tok = out.tokens[-1].clone()
    host.update(done=out.done.cpu().numpy(),
                n_emitted=out.n_emitted.cpu().numpy())
    if sampled:
        host["temperatures"] = np.array([1.3, 0.7, 0.0, 0.2], np.float32)
    want = eager(tok, host)
    before = dict(kmod.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = compiled(state, tok, num_steps=steps, live_cap=2, **host)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert {k: kmod.LAUNCHES[k] - before[k] for k in before} == \
        {k: entry.launches[k] for k in before}
    assert len(state.entries) == 1                       # replayed
    _chunk_equal(out, want)
    for f in ("k", "v", "positions", "length", "offset"):
        assert torch.equal(getattr(state.caches["layers"], f),
                           getattr(ref_caches["layers"], f)), f
    assert compiled.pool_bytes() > 0


def test_cuda_evicted_decode_states_free_their_graphs():
    """Decode states dropped by the engine's bound take their graphs with
    them, and capture resumes in a fresh pool once no graph is left: on the
    reduced OLMoE, sessions of three slot buckets with at most one idle
    state kept, then none, give the tokens of the same engine's eager
    chunk (``graphs=False``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, Request
    from repro_torch.serving.compiled import CompiledDecodeChunk

    dev = _need_cuda()
    cfg = get_config("olmoe_1b_7b").reduced()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = DyMoEEngine(cfg, params, device=dev)
    rng = np.random.default_rng(3)
    sets = [[Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, p)], max_new_tokens=m) for p, m in spec]
        for spec in ([(9, 6), (20, 9)], [(30, 12), (5, 4)],
                     [(70, 10), (12, 3)])]
    graphs = eng._decode_batched
    eager = CompiledDecodeChunk(eng, graphs=False)
    for keep in (1, 0):
        graphs.max_idle_states = keep
        for reqs in sets:
            eng._decode_batched = eager
            want = [r.tokens for r in eng.generate_batch(reqs, num_slots=2)]
            eng._decode_batched = graphs
            got = [r.tokens for r in eng.generate_batch(reqs, num_slots=2)]
            assert got == want
            assert eng.last_stats["compiles"] > 0       # a new state
            assert len(graphs.states()) == keep
        assert (graphs._pool is None) == (keep == 0)


def _reduced_engines(dev, faults_cpu=None, faults_dev=None):
    """The reduced f32 OLMoE from one CPU generator, as an engine on the
    CPU (the plain path) and one on the card, each with its injector."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine

    cfg = get_config("olmoe_1b_7b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return (cfg, DyMoEEngine(cfg, params, faults=faults_cpu, device="cpu"),
            DyMoEEngine(cfg, params, faults=faults_dev, device=dev))


def _session_outcomes(eng, cfg, specs):
    """Six ragged requests through a 2-slot session (slots 64), driven to
    idle: every handle's tokens or typed-error class and modeled numbers,
    and the health counters (``last_fault`` aside)."""
    import dataclasses

    session = eng.serve(num_slots=2, slots_len=64)
    rng = np.random.default_rng(3)
    handles = [session.submit(r) for r in specs(rng)]
    session.drain(cancel_queued=False)
    health = dataclasses.asdict(session.health())
    health.pop("last_fault")
    session.close()
    out = []
    for h in handles:
        if h.error is not None:
            out.append((h.request_id, type(h.error).__name__))
        else:
            r = h.result(drive=False)
            out.append((h.request_id, r.tokens, r.ttft_s, r.tpot_s,
                         r.cache_stats, r.decode_weight_bytes_per_tok))
    return out, health


def _six(rng):
    from repro_torch.serving import Request
    return [Request(prompt_tokens=[int(v) for v in rng.integers(1, 500, n)],
                    max_new_tokens=m, request_id=f"req-{i}")
            for i, (n, m) in enumerate(
                [(8, 6), (5, 4), (9, 8), (6, 3), (7, 5), (4, 7)])]


@pytest.mark.parametrize("times", [1, 6], ids=["retry", "burst"])
def test_cuda_session_with_dispatch_fault_equals_cpu(times):
    """An open session on the reduced f32 OLMoE with ``device.dispatch``
    failing ``times`` attempts from the second on: one retry on a halved
    chunk (a new graph key), or a burst down the whole ladder (16, 8, 4, 2,
    1 steps, then a deferred row) to a ``DispatchError``. The card's
    outcomes — tokens, typed errors, modeled TTFT/TPOT, cache stats — and
    health counters equal the CPU's; the decode state goes back to the
    engine at ``close()``."""
    from repro_torch.serving import FaultInjector, FaultSpec

    dev = _need_cuda()

    def inj():
        return FaultInjector([FaultSpec(site="device.dispatch", at=1,
                                        times=times)])

    cfg, cpu, gpu = _reduced_engines(dev, inj(), inj())
    want = _session_outcomes(cpu, cfg, _six)
    got = _session_outcomes(gpu, cfg, _six)
    assert got == want
    assert got[1]["dispatch_retries"] == times
    assert (got[1]["dispatch_failures"] > 0) == (times > 1)
    assert not any(st.held for st in gpu._decode_batched.states())
    assert gpu._decode_batched.compiles >= 2     # the halved chunk's key


def test_cuda_close_after_fault_gives_state_back():
    """A session whose step raised an error the ladder does not take (a
    plain RuntimeError from the chunk) still gives its decode state back
    at ``close()``, resolving its handles with ``SessionClosed``; the next
    session acquires that state and serves the CPU's tokens."""
    from repro_torch.serving import SessionClosed
    from repro_torch.serving.compiled import CompiledDecodeChunk

    dev = _need_cuda()
    cfg, cpu, gpu = _reduced_engines(dev)
    s = gpu.serve(num_slots=2, slots_len=64)
    hs = [s.submit(r) for r in _six(np.random.default_rng(3))]
    s.step()
    def fail(self, *a, **kw):
        raise RuntimeError("device error")

    inner = CompiledDecodeChunk.__call__
    CompiledDecodeChunk.__call__ = fail
    try:
        with pytest.raises(RuntimeError, match="device error"):
            s.step()
    finally:
        CompiledDecodeChunk.__call__ = inner
    assert s.health().dispatch_retries == 0
    (state,) = gpu._decode_batched.states()
    s.close()
    assert not state.held
    assert any(isinstance(h.error, SessionClosed) for h in hs)
    assert _session_outcomes(gpu, cfg, _six) == \
        _session_outcomes(cpu, cfg, _six)
    assert gpu._decode_batched.states() == [state]


def test_cuda_generate_reference_launches_k2_on_decode():
    """``generate_reference`` on the card: the solo prefill and every
    decode step (``decode_step(per_row_moe=False)``, experts at M 1 per
    expert) run K2, three launches a layer, and no K1; tokens and modeled
    numbers equal the CPU's, greedy and sampled."""
    from repro_torch.serving import Request

    dev = _need_cuda()
    cfg, cpu, gpu = _reduced_engines(dev)
    rng = np.random.default_rng(5)
    for temp, seed in ((0.0, None), (0.8, 11)):
        req = Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, 13)], max_new_tokens=7, temperature=temp,
            top_k=20, seed=seed)
        want = cpu.generate_reference(req)
        kmod.reset_launch_counts()
        got = gpu.generate_reference(req)
        torch.cuda.synchronize()
        assert kmod.LAUNCHES["expert_quant_matmul"] == \
            3 * cfg.num_layers * 7          # prefill + 6 decode steps
        assert kmod.LAUNCHES["expert_quant_matmul_grouped"] == 0
        assert got.tokens == want.tokens
        assert (got.ttft_s, got.tpot_s, got.cache_stats) == \
            (want.ttft_s, want.tpot_s, want.cache_stats)
