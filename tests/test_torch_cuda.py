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
eager chunk (``test_cuda_compiled_chunk_equals_eager``), also on ring
caches of a sliding window, whose writes equal the CPU's
(``test_cuda_compiled_chunk_ring_*``, ``test_cuda_ring_*``); the open session
with a ``device.dispatch`` fault against the CPU, ``close()`` after an
unretried fault giving its decode state back, and ``generate_reference``
running K2 on decode (``test_cuda_session_*``, ``test_cuda_close_*``,
``test_cuda_generate_reference_*``); K2 at one expert, the dense and SSM
projections' shapes (``test_cuda_expert_one_expert_*``), and the non-MoE
architectures: the compiled chunk on KV, SSM and hybrid decode states
against the eager chunk, and serving on the card against the CPU
(``test_cuda_compiled_chunk_non_moe_*``, ``test_cuda_non_moe_*``); the
compiled prefill, a CUDA graph replay per prompt shape, against the eager
prefill for every block family, and its pool and bound
(``test_cuda_compiled_prefill_*``); the compiled ``decode_many`` of
``generate_reference`` and the static batch against eager, greedy,
sampled and per row (``test_cuda_compiled_decode_many_*``), and two
replicas of one engine on driver threads capturing while they step
(``test_cuda_threaded_replicas_*``); and the training path: train steps on
the card against the CPU, a checkpoint of CUDA tensors
(``test_cuda_train_*``, ``test_cuda_checkpoint_*``); and 4 gloo ranks
sharing the card, serving expert- and tensor-parallel over a mesh
(``test_cuda_expert_parallel_*``); and the invariant linter on the card:
the reduced OLMoE's admission wave and decode chunk traced through the
CUDA kernels under ``set_sync_debug_mode("error")`` with zero findings
and one kernel scope per launch, and every kernel instantiation's
``cudaFuncGetAttributes`` against the shared-memory mirror and the
register and spill budgets (``test_cuda_lint_*``).
(The engine's greedy tokens on the card
against the plain path on the CPU are checked by ``chip_smoke.py``'s
reference phase.) Imports no JAX, so it runs where the card is:
``python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py``.
Every test skips (and says why) where there is no GPU."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_with_scores
from repro_torch.kernels.attn_scores import attn_scores as amod
from repro_torch.kernels.quant_matmul import expert_quant_matmul as kmod
from repro_torch.kernels.quant_matmul import quant_matmul as dmod
from repro_torch.models.kv_cache import cache_tensors
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


@pytest.mark.parametrize("k,n", [(256, 1064), (1024, 3072), (2048, 8384),
                                 (3072, 1024)])
@pytest.mark.parametrize("m", [1, 4, 37, 512])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32],
                         ids=["x_bf16", "x_f32"])
@pytest.mark.parametrize("tier", [1, 0], ids=["hi", "lo"])
def test_cuda_expert_one_expert_matches_plain(tier, x_dtype, m, k, n):
    """K2 at E = 1, as ``quant/mixed.py``'s lift runs every dense FFN and
    SSM projection, "4/2" at either tier: the reduced zamba2's in_proj
    (N 1064) and full-width qwen3_0p6b's and zamba2_1p2b's shapes, whose N
    is not a multiple of the 128-column tile (the last tile's codes and
    scales are staged with zero fill past N), at decode (M 1, 4), a ragged
    64-row tile (37) and prefill (512)."""
    dev = _need_cuda()
    rng = np.random.default_rng(k + n + m + tier)
    w = torch.from_numpy(rng.standard_normal((1, k, n)).astype(
        np.float32)).to(dev) * k ** -0.5
    mp = MixedPrecisionWeights.build(w, 4, 2, 64)
    x = torch.from_numpy(rng.standard_normal((1, m, k)).astype(
        np.float32)).to(dev, x_dtype)
    args = (mp.high.packed, mp.high.scales, mp.low.packed, mp.low.scales,
            torch.full((1,), tier, dtype=torch.int32, device=dev))
    _held_to_plain(kmod, "expert_quant_matmul", x, x, args,
                   dict(hi_bits=4, lo_bits=2, group_size=64))


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


@pytest.mark.parametrize("s", [8, 20, 24])
def test_cuda_ring_fill_and_update_equal_cpu(s):
    """A ring of 8 slots filled with S keys on the card (S == W; S > W, the
    trailing W kept at p % W; S = 3W, no rotation) and then 11 decode
    writes with rows frozen at random: every field bitwise the same
    cache's on the CPU after every write (the writes are copies)."""
    from repro_torch.models.kv_cache import cache_tensors, fill_kv_cache, \
        init_kv_cache, update_kv_cache

    dev = _need_cuda()
    rng = np.random.default_rng(s)
    b, h, w, d = 3, 2, 8, 16
    k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(2))
    caches = [fill_kv_cache(init_kv_cache(b, h, w, d, torch.bfloat16, where,
                                          ring=True), k.to(where),
                            v.to(where)) for where in ("cpu", dev)]
    for step in range(12):
        for f, x in cache_tensors(caches[0]):
            assert torch.equal(getattr(caches[1], f).cpu(), x), (f, step)
        assert sorted(caches[0].positions[0].tolist()) == \
            list(range(s + step - w, s + step))
        kn, vn = (torch.from_numpy(rng.standard_normal((b, h, 1, d)).astype(
            np.float32)) for _ in range(2))
        live = torch.from_numpy(rng.random(b) > 0.3)
        live[0] = True
        for c in caches:
            dv = c.k.device
            update_kv_cache(c, kn.to(dv), vn.to(dv), live=live.to(dv))


@pytest.mark.parametrize("s", [5, 20])
def test_cuda_compiled_chunk_ring_equals_eager(s):
    """The compiled decode chunk on ring caches (reduced OLMoE with an
    8-token window; the state is a ring of W slots): prompts of 5 (the
    ring wraps inside the first chunk) and 20 (the prefill kept the last
    8 keys, the ring wraps again mid-chunk), 4 slots, one dead, one row
    stopping mid-chunk. Capture, then a replay under
    ``set_sync_debug_mode("error")``: tokens, masks, done, emitted and
    every cache leaf bitwise eager ``decode_many_batched``'s."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.kv_cache import cache_tensors
    from repro_torch.models.model import decode_many_batched, init_params, \
        prefill
    from repro_torch.serving import DyMoEEngine

    dev = _need_cuda()
    w = 8
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(),
                              sliding_window=w)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = DyMoEEngine(cfg, params, device=dev)
    b, steps = 4, 6
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    logits, rc, _ = prefill(eng.params, cfg, prompts, qparams=eng.qparams)
    compiled = eng._decode_batched
    state = compiled.acquire(b, w)
    assert rc["layers"].ring and state.caches["layers"].ring
    ref = {"layers": dataclasses.replace(rc["layers"], **{
        f: x.clone() for f, x in cache_tensors(rc["layers"])})}
    state.load(rc)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    host = dict(done=np.array([False, True, False, False]),
                n_emitted=np.ones(b, np.int32),
                limits=np.array([20, 20, 4, 20], np.int32),
                eos_tokens=np.full(b, -1, np.int32))
    for c in range(2):
        kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        want = decode_many_batched(
            eng.params, cfg, tok.clone(), ref, num_steps=steps,
            done=kw["done"], n_emitted=kw["n_emitted"], limits=kw["limits"],
            eos_tokens=kw["eos_tokens"], qparams=eng.qparams, live_cap=4)
        torch.cuda.synchronize()
        if c:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = compiled(state, tok, num_steps=steps, live_cap=4, **host)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        _chunk_equal(out, want)
        for f, x in cache_tensors(ref["layers"]):
            assert torch.equal(getattr(state.caches["layers"], f), x), (c, f)
        tok = out.tokens[-1].clone()
        host.update(done=out.done.cpu().numpy(),
                    n_emitted=out.n_emitted.cpu().numpy())
    (entry,) = state.entries.values()
    assert entry.graph is not None
    assert sorted(state.caches["layers"].positions[0, 0].tolist()) == \
        list(range(s + 2 * steps - w, s + 2 * steps))
    compiled.release(state)


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
    numbers equal the CPU's, greedy and sampled. The three calls share one
    prefill key: the first prefills eagerly, the second captures it and the
    third replays it, each with the same launch counts."""
    from repro_torch.serving import Request

    dev = _need_cuda()
    cfg, cpu, gpu = _reduced_engines(dev)
    rng = np.random.default_rng(5)
    compiles = []
    for temp, seed in ((0.0, None), (0.8, 11), (0.0, None)):
        req = Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, 13)], max_new_tokens=7, temperature=temp,
            top_k=20, seed=seed)
        want = cpu.generate_reference(req)
        kmod.reset_launch_counts()
        n0 = gpu._prefill.compiles
        got = gpu.generate_reference(req)
        torch.cuda.synchronize()
        compiles.append(gpu._prefill.compiles - n0)
        assert kmod.LAUNCHES["expert_quant_matmul"] == \
            3 * cfg.num_layers * 7          # prefill + 6 decode steps
        assert kmod.LAUNCHES["expert_quant_matmul_grouped"] == 0
        assert got.tokens == want.tokens
        assert (got.ttft_s, got.tpot_s, got.cache_stats) == \
            (want.ttft_s, want.tpot_s, want.cache_stats)
    assert compiles == [0, 1, 0]


def _arch_engines(dev, arch, **over):
    """A reduced f32 non-MoE config from one CPU generator, as an engine on
    the CPU (the plain path) and one on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine

    cfg = get_config(arch).reduced(**over)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return (cfg, DyMoEEngine(cfg, params, device="cpu"),
            DyMoEEngine(cfg, params, device=dev))


def _k2_per_layer(eng):
    """K2 launches a layer makes per prefill or decode step: one per
    packed FFN matrix (SwiGLU 3, GELU 2) or SSM projection (2)."""
    q = eng.qparams["layers"]
    return len(q["mlp"] if "mlp" in q else q["ssm"])


_ARCHS = {"qwen3_0p6b": {}, "musicgen_medium": {},
          "zamba2_1p2b": dict(num_layers=4), "falcon_mamba_7b": {}}


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_cuda_compiled_chunk_non_moe_equals_eager(arch):
    """The compiled decode chunk on a non-MoE decode state — KV caches
    (dense), an SSM state (Mamba1), an SSM state and a two-site shared KV
    stack (the hybrid) — against eager ``decode_many_batched`` from a copy
    of the same state: 4 slots, one dead, one row reaching its limit
    mid-chunk. Two chunks (capture, then a replay under
    ``set_sync_debug_mode("error")``): tokens, done, emitted and every
    cache leaf bitwise equal; each replay adds the K2 launches of its
    capture, (3 SwiGLU, 2 GELU or SSM) x L a step, and no K1."""
    import dataclasses

    from repro_torch.models.model import decode_many_batched, prefill

    dev = _need_cuda()
    cfg, _, eng = _arch_engines(dev, arch, **_ARCHS[arch])
    b, s, slots, steps = 4, 9, 40, 6
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(1))
    logits, rc, _ = prefill(eng.params, cfg, prompts, qparams=eng.qparams,
                            cache_slots=slots)
    compiled = eng._decode_batched
    state = compiled.acquire(b, slots)
    ref = {}
    for part, c in rc.items():
        ref[part] = dataclasses.replace(
            c, **{f: x.clone() for f, x in cache_tensors(c)})
        for f, x in cache_tensors(c):
            getattr(state.caches[part], f).copy_(x)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    host = dict(done=np.array([False, True, False, False]),
                n_emitted=np.ones(b, np.int32),
                limits=np.array([20, 20, 4, 20], np.int32),
                eos_tokens=np.full(b, -1, np.int32))
    per_step = _k2_per_layer(eng) * cfg.num_layers
    for c in range(2):
        kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        want = decode_many_batched(
            eng.params, cfg, tok.clone(), ref, num_steps=steps,
            done=kw["done"], n_emitted=kw["n_emitted"], limits=kw["limits"],
            eos_tokens=kw["eos_tokens"], qparams=eng.qparams, live_cap=4)
        torch.cuda.synchronize()
        before = dict(kmod.LAUNCHES)
        if c:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = compiled(state, tok, num_steps=steps, live_cap=4, **host)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        (entry,) = state.entries.values()
        assert entry.launches["expert_quant_matmul"] == per_step * steps
        assert entry.launches["expert_quant_matmul_grouped"] == 0
        if c:
            assert {k: kmod.LAUNCHES[k] - before[k] for k in before} == \
                {k: entry.launches[k] for k in before}
        toks, _, info, dn, emitted = want
        assert info.critical_masks is None and out.info.critical_masks is None
        assert torch.equal(out.tokens, toks)
        assert torch.equal(out.done, dn) and \
            torch.equal(out.n_emitted, emitted)
        for part, cache in ref.items():
            for f, x in cache_tensors(cache):
                assert torch.equal(getattr(state.caches[part], f), x), \
                    (part, f)
        tok = out.tokens[-1].clone()
        host.update(done=out.done.cpu().numpy(),
                    n_emitted=out.n_emitted.cpu().numpy())
    assert host["done"][2] and not host["done"][0]
    compiled.release(state)


@pytest.mark.parametrize("arch", list(_ARCHS))
def test_cuda_non_moe_serving_equals_cpu(arch):
    """``generate_batch`` (ragged requests, 2 slots: batched waves for the
    dense kinds, one solo prefill a request for the SSM kinds) and
    ``generate_reference`` of a reduced f32 non-MoE config on the card
    against the CPU: tokens and modeled TTFT/TPOT equal; K2 launches
    (3 SwiGLU, 2 GELU or SSM) x L per prefill, decode step and capture
    warm-up step, no K1."""
    from repro_torch.serving import Request

    dev = _need_cuda()
    cfg, cpu, gpu = _arch_engines(dev, arch, **_ARCHS[arch])
    rng = np.random.default_rng(4)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, n)], max_new_tokens=m)
        for n, m in ((8, 6), (15, 9), (5, 1), (11, 12))]
    want = cpu.generate_batch(reqs, num_slots=2)
    kmod.reset_launch_counts()
    got = gpu.generate_batch(reqs, num_slots=2)
    torch.cuda.synchronize()
    st = gpu.last_stats
    assert kmod.LAUNCHES["expert_quant_matmul"] == _k2_per_layer(gpu) * \
        cfg.num_layers * (st["decode_steps"] + st["waves_batched"]
                          + st["waves_solo"] + st["compiles"])
    assert kmod.LAUNCHES["expert_quant_matmul_grouped"] == 0
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [(r.ttft_s, r.tpot_s) for r in got] == \
        [(r.ttft_s, r.tpot_s) for r in want]
    ref_c, ref_g = cpu.generate_reference(reqs[3]), \
        gpu.generate_reference(reqs[3])
    assert ref_g.tokens == ref_c.tokens == got[3].tokens
    assert (ref_g.ttft_s, ref_g.tpot_s) == (ref_c.ttft_s, ref_c.tpot_s)


# case -> (config name, reduced() overrides, "wave" | "solo", "4/2" | "4/0")
_PREFILLS = {"olmoe-wave": ("olmoe_1b_7b", {}, "wave", 2),
             "olmoe-solo-4/2": ("olmoe_1b_7b", {}, "solo", 2),
             "olmoe-solo-4/0": ("olmoe_1b_7b", {}, "solo", 0),
             "qwen3_0p6b-wave": ("qwen3_0p6b", {}, "wave", 2),
             "zamba2_1p2b-solo": ("zamba2_1p2b", dict(num_layers=4), "solo",
                                  2),
             "falcon_mamba_7b-solo": ("falcon_mamba_7b", {}, "solo", 2)}


def _prefill_case(dev, name):
    """A reduced engine on the card and a prompt maker for one case: a
    right-aligned wave of lengths 11, 4, 7 (lengths, row-local, MoE exact
    row capacities) or a solo prompt of 13."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.layers.moe import _capacity
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine

    arch, over, mode, low = _PREFILLS[name]
    cfg = get_config(arch).reduced(**over)
    cfg = dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=low))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = DyMoEEngine(cfg, params, device=dev)

    def inputs(seed):
        rng = np.random.default_rng(seed)
        if mode == "solo":
            return rng.integers(1, cfg.vocab_size, (1, 13)), {}
        lens = np.array([11, 4, 7], np.int32)
        prompt = np.zeros((3, 11), np.int64)
        for i, s in enumerate(lens):
            prompt[i, 11 - s:] = rng.integers(1, cfg.vocab_size, s)
        kw = dict(lengths=lens, row_local=True)
        if cfg.is_moe:
            kw["row_capacities"] = np.array(
                [_capacity(cfg, int(s)) for s in lens], np.int64)
        return prompt, kw

    return cfg, eng, mode, inputs


@pytest.mark.parametrize("name", list(_PREFILLS))
def test_cuda_compiled_prefill_equals_eager(name):
    """The engine's compiled prefill (a CUDA graph per key) against eager
    ``prefill`` on the same inputs, for each block family: a row-local
    OLMoE wave (K1), solo OLMoE admissions in "4/2" and "4/0" (K2), a
    dense wave, the hybrid (SSM state and shared-site KV) and Mamba1 solo
    (K2 at one expert). Three calls of one key with new prompts, each
    under ``set_sync_debug_mode("error")`` (the first runs eagerly, the
    second captures and replays, the third replays into the second's
    tensors): logits, every ``DyMoEInfo`` leaf and every cache leaf
    bitwise equal; each call adds exactly the key's launch counts, 3
    (MoE, SwiGLU) or 2 (SSM) x L of K1 (wave) or K2 (solo, non-MoE); the
    graph lives in the prefill's own pool."""
    from repro_torch.models.model import prefill
    from repro_torch.serving.compiled import PrefillOut

    dev = _need_cuda()
    cfg, eng, mode, inputs = _prefill_case(dev, name)
    cp = eng._prefill
    q = eng.qparams["layers"]
    per_layer = 3 if cfg.is_moe else len(q["mlp"] if "mlp" in q else q["ssm"])
    k1, k2 = "expert_quant_matmul_grouped", "expert_quant_matmul"
    wave_moe = cfg.is_moe and mode == "wave"
    n = per_layer * cfg.num_layers
    launches = {k: 0 for k in kmod.LAUNCHES}
    launches.update({k1: n if wave_moe else 0, k2: 0 if wave_moe else n})
    fixed = None
    for call in range(3):
        prompt, kw = inputs(call)
        dkw = {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
               else v for k, v in kw.items()}
        want = PrefillOut(*prefill(
            eng.params, cfg, torch.from_numpy(prompt).to(dev),
            qparams=eng.qparams, cache_slots=40, **dkw)).tensors()
        torch.cuda.synchronize()
        before = dict(kmod.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = cp(prompt, cache_slots=40, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        got = out.tensors()
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), i
        assert {k: kmod.LAUNCHES[k] - before[k] for k in before} == \
            {k: launches[k] for k in before}
        (entry,) = cp.entries().values()
        assert (entry.graph is not None) == (call > 0)
        if call == 2:
            assert all(a is b for a, b in zip(got, fixed))
        fixed = got
    assert {k: entry.launches[k] for k in launches} == launches
    assert cp.compiles == 1 and cp.pool_bytes() > 0
    assert cp._pool != eng._decode_batched._pool


def test_cuda_compiled_prefill_bound_frees_graphs():
    """Prefill keys beyond ``max_entries`` are dropped with their graphs,
    and the pool goes once none is left: on the reduced OLMoE, solo
    prompts of four lengths with two entries kept (the recurring one
    captured and replayed) give eager ``prefill``'s logits bitwise; with
    none kept nothing is captured and the pool is dropped; a key met
    twice after that captures into a fresh pool; a ``generate_batch``
    after it equals the CPU's tokens."""
    from repro_torch.models.model import prefill
    from repro_torch.serving import Request

    dev = _need_cuda()
    cfg, cpu, gpu = _reduced_engines(dev)
    cp = gpu._prefill
    rng = np.random.default_rng(8)
    for keep, lengths in ((2, (5, 9, 14, 9, 9)), (0, (5, 9)), (2, (9, 9))):
        cp.max_entries = keep
        for s in lengths:
            prompt = rng.integers(1, cfg.vocab_size, (1, s))
            want, _, _ = prefill(gpu.params, cfg,
                                 torch.from_numpy(prompt).to(dev),
                                 qparams=gpu.qparams, cache_slots=32)
            got = cp(prompt, cache_slots=32).logits
            assert torch.equal(got, want)
            assert len(cp.entries()) <= keep
        assert (cp._pool is None) == (keep == 0)
    assert cp.compiles == 2
    cp.max_entries = 8
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, p)], max_new_tokens=m)
        for p, m in ((9, 6), (20, 9), (9, 4))]
    assert [r.tokens for r in gpu.generate_batch(reqs, num_slots=2)] == \
        [r.tokens for r in cpu.generate_batch(reqs, num_slots=2)]


def test_cuda_compiled_prefill_capture_oom_is_not_retried(monkeypatch):
    """An out-of-memory error raised inside a prefill capture reaches the
    caller as a ``RuntimeError`` (not ``torch.OutOfMemoryError``, which
    the admission ladder would retry), with the launch counts as they
    were; the key keeps no graph, and its next call captures and equals
    eager ``prefill`` bitwise."""
    from repro_torch.models.model import prefill
    from repro_torch.serving import compiled as compiled_mod

    dev = _need_cuda()
    cfg, _, gpu = _reduced_engines(dev)
    cp = gpu._prefill
    rng = np.random.default_rng(9)
    inner = compiled_mod.prefill

    def failing(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            raise torch.OutOfMemoryError("out of memory")
        return inner(*args, **kw)

    prompt = rng.integers(1, cfg.vocab_size, (1, 11))
    cp(prompt, cache_slots=32)                       # the eager first call
    monkeypatch.setattr(compiled_mod, "prefill", failing)
    before = dict(kmod.LAUNCHES)
    with pytest.raises(RuntimeError) as err:
        cp(prompt, cache_slots=32)
    assert not isinstance(err.value, torch.OutOfMemoryError)
    assert isinstance(err.value.__cause__, torch.OutOfMemoryError)
    assert dict(kmod.LAUNCHES) == before
    (entry,) = cp.entries().values()
    assert entry.graph is None and cp.compiles == 0
    monkeypatch.setattr(compiled_mod, "prefill", inner)
    prompt = rng.integers(1, cfg.vocab_size, (1, 11))
    want, _, _ = prefill(gpu.params, cfg, torch.from_numpy(prompt).to(dev),
                         qparams=gpu.qparams, cache_slots=32)
    assert torch.equal(cp(prompt, cache_slots=32).logits, want)
    assert cp.compiles == 1 and entry.graph is not None


@pytest.mark.parametrize("mode", ["greedy", "sampled", "rows"])
def test_cuda_compiled_decode_many_equals_eager(mode):
    """The engine's compiled ``decode_many`` (``generate_reference``'s and
    the static batch's chunks) against eager ``decode_many`` from a copy
    of the same prefill caches, on the reduced OLMoE: one row greedy or
    sampled with one key, or three rows sampled per row. The key's first
    call runs eagerly, the second captures and replays (from the first's
    outputs, at the next start step), the third replays under
    ``set_sync_debug_mode("error")``: tokens, telemetry and the state's
    caches bitwise eager's, and each call adds exactly 3 × L × steps K2
    launches. The state's caches share no storage with the prefill's."""
    import dataclasses

    from repro_torch.models.model import decode_many, prefill

    dev = _need_cuda()
    cfg, _, eng = _reduced_engines(dev)
    b = 3 if mode == "rows" else 1
    s, slots, steps = 11, 40, 5
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(2))
    logits, rc, _ = prefill(eng.params, cfg, prompts, qparams=eng.qparams,
                            cache_slots=slots)
    ref = {"layers": dataclasses.replace(
        rc["layers"], **{f: getattr(rc["layers"], f).clone() for f in
                         ("k", "v", "positions", "length", "offset")})}
    cm = eng._decode_many
    state = cm.acquire(b, slots, caches=rc)
    def ptrs(caches):
        return {x.untyped_storage().data_ptr()
                for c in caches.values() for _, x in cache_tensors(c)}

    assert not ptrs(rc) & ptrs(state.caches)
    kw, eager_kw = {}, {}
    if mode == "sampled":
        kw = dict(rng_key=np.array([0, 7], np.int64), temperature=0.8,
                  top_k=20)
        eager_kw = dict(rng_key=torch.tensor([0, 7], device=dev),
                        temperature=0.8, top_k=20)
    elif mode == "rows":
        kw = dict(row_keys=np.arange(6, dtype=np.int64).reshape(3, 2),
                  row_temperatures=np.array([0.7, 0.0, 1.2], np.float32),
                  row_top_ks=np.array([0, 5, 20], np.int64))
        eager_kw = {k: torch.from_numpy(v).to(dev) for k, v in kw.items()}
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    k2 = "expert_quant_matmul"
    for call in range(3):
        start = 1 + call * steps
        want_t, _, want_i = decode_many(
            eng.params, cfg, tok.clone(), ref, num_steps=steps,
            start_step=start, qparams=eng.qparams, **eager_kw)
        before = dict(kmod.LAUNCHES)
        torch.cuda.synchronize()
        if call == 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = cm(state, tok, num_steps=steps, start_step=start, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert kmod.LAUNCHES[k2] - before[k2] == 3 * cfg.num_layers * steps
        assert torch.equal(out.tokens, want_t), call
        for f in ("critical_masks", "active_masks", "gate_mean",
                  "predicted_next"):
            assert torch.equal(getattr(out.info, f), getattr(want_i, f)), f
        for f in ("k", "v", "positions", "length", "offset"):
            assert torch.equal(getattr(state.caches["layers"], f),
                               getattr(ref["layers"], f)), f
        tok = out.tokens[-1].clone()
    (entry,) = state.entries.values()
    assert entry.graph is not None and cm.compiles == 1
    cm.release(state)


def test_cuda_threaded_replicas_capture_while_stepping():
    """Two replicas of one engine on driver threads, serving requests of
    one prompt length and mixed lengths of output from a cold engine:
    the replicas' first waves share a prefill key (one thread's call is
    eager, the other's captures it) and each replica's chunks meet new
    keys, so one thread captures graphs while the other steps; the
    engine's lock keeps them apart, and every request's tokens equal a
    solo run on a second engine from the same weights;
    ``generate_reference`` calls on the test's thread, meanwhile, equal
    the second engine's."""
    from repro_torch.serving import ClusterRouter, DyMoEEngine, \
        EngineConfig, Request

    dev = _need_cuda()
    cfg, cpu, eng = _reduced_engines(dev)
    solo_eng = DyMoEEngine(cfg, cpu.params, device=dev)
    rng = np.random.default_rng(12)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, 9)], max_new_tokens=m, request_id=f"r{i}")
        for i, m in enumerate((6, 9, 12, 4, 7, 5, 10, 3))]
    want = [solo_eng.generate(r).tokens for r in reqs]
    refs = [solo_eng.generate_reference(r).tokens for r in reqs[:3]]
    router = ClusterRouter.replicate(eng, 2, num_slots=2, slots_len=64,
                                     threaded=True)
    try:
        handles = [router.submit(r) for r in reqs]
        got_ref = [eng.generate_reference(r).tokens for r in reqs[:3]]
        got = [h.result().tokens for h in handles]
        health = router.health()
    finally:
        router.close()
    assert got == want and got_ref == refs
    assert {h.replica for h in handles} == {0, 1}
    assert eng._decode_batched.compiles > 0 and eng._prefill.compiles > 0
    assert health.completed == len(reqs)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_1p2b"])
def test_cuda_train_steps_equal_cpu(arch):
    """Three train steps (``train_step_fn``, AdamW lr 1e-2) of the reduced
    f32 config on the card and on the CPU from the same params and
    batches, TF32 off: each step's loss, ce and aux at rtol 1e-4 (losses,
    not params: Adam's first steps are near lr · sign(g), and a grad near
    zero may take another sign on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.models.model import init_params, train_step_fn
    from repro_torch.training import AdamW, constant_lr
    from repro_torch.tree import tree_leaves, tree_map

    dev = _need_cuda()
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = AdamW(lr=constant_lr(1e-2), weight_decay=0.01)
    step = train_step_fn(cfg, opt)
    runs = {}
    for d in ("cpu", dev):
        p = tree_map(lambda x: x.to(d), params)
        state, hist = opt.init(p), []
        for b in itertools.islice(synthetic_lm_batches(DataConfig(
                4, 32, cfg.vocab_size)), 3):
            p, state, m = step(p, state, {k: torch.as_tensor(v, device=d)
                                          for k, v in b.items()})
            hist.append({k: float(v) for k, v in m.items()})
        runs[str(d)] = hist
        assert all(x.device.type == torch.device(d).type
                   for x in tree_leaves(p))
    for c, g in zip(runs["cpu"], runs[str(dev)]):
        for k in ("loss", "ce", "aux"):
            assert g[k] == pytest.approx(c[k], rel=1e-4, abs=1e-7), (k, c, g)


def test_cuda_checkpoint_bf16_round_trip(tmp_path):
    """A tree of CUDA tensors (bf16, f32, int32) through ``save_checkpoint``
    and back into a CUDA template: bit for bit, same dtypes, on the card;
    ``TrainLoop`` with no device trains on the card."""
    from repro_torch.configs import get_config
    from repro_torch.training import TrainLoop, TrainLoopConfig, \
        latest_step, load_checkpoint, save_checkpoint
    from repro_torch.tree import tree_map, tree_paths

    dev = _need_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"w": torch.randn(3, 5, generator=g, device=dev).to(
        torch.bfloat16), "b": {"s": torch.randn(7, generator=g, device=dev)},
        "n": torch.arange(4, dtype=torch.int32, device=dev)}
    save_checkpoint(str(tmp_path), 2, tree)
    back, step = load_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                                 tree_map(torch.empty_like, tree))
    assert step == 2
    for k, v in tree_paths(tree).items():
        r = tree_paths(back)[k]
        assert r.dtype == v.dtype and r.device == v.device
        assert torch.equal(r.view(torch.uint8), v.view(torch.uint8)), k
    loop = TrainLoop(get_config("olmoe_1b_7b").reduced(),
                     TrainLoopConfig(steps=2, log_every=1))
    assert loop.params["embed"].device.type == "cuda"


def _ep_card_rank(rank, device, cfg, reqs, ep):
    """One of 4 gloo ranks sharing the card: its shards of the weights
    drawn on the card, a sharded engine, the batch's tokens and the K1/K2
    launches of this rank."""
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.models.model import init_sharded
    from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig

    mesh = make_sim_mesh(4)
    gen = torch.Generator(device=device).manual_seed(0)
    params, q = init_sharded(cfg, gen, mesh, expert_parallel=ep,
                             device=device)
    eng = DyMoEEngine(cfg, params, EngineConfig(
        profile=EdgeProfile().with_vram(12), decode_chunk=4), device=device,
        qparams=q, mesh=mesh, expert_parallel=ep)
    kmod.reset_launch_counts()
    toks = [r.tokens for r in eng.generate_batch(reqs, num_slots=2)]
    return toks, dict(kmod.LAUNCHES), dict(eng.last_stats)


@pytest.mark.parametrize("ep", [True, False], ids=["ep", "tp"])
def test_cuda_expert_parallel_ranks_share_the_card(ep):
    """4 gloo ranks on one card (``launch.mesh.spawn``), expert- and
    tensor-parallel: every rank's tokens equal the one-rank CPU run of the
    same weights (drawn on the card, moved to the CPU), each rank launches
    K1 and K2 as the one-rank card run does, and the chunks run eagerly
    (no compile; gloo's collectives cannot be captured)."""
    dev = _need_cuda()
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig, \
        Request

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    reqs = [Request(prompt_tokens=list(range(1 + i, 13 + 3 * i)),
                    max_new_tokens=4 + i, request_id=f"req-{i}")
            for i in range(4)]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    ecfg = EngineConfig(profile=EdgeProfile().with_vram(12), decode_chunk=4)
    cpu = DyMoEEngine(cfg, params, ecfg,
                      device="cpu")
    want = [r.tokens for r in cpu.generate_batch(reqs, num_slots=2)]
    card = DyMoEEngine(cfg, params, ecfg, device=dev)
    card.generate_batch(reqs, num_slots=2)       # warm: captures
    kmod.reset_launch_counts()
    card.generate_batch(reqs, num_slots=2)
    one_rank = dict(kmod.LAUNCHES)
    ranks = spawn(_ep_card_rank, 4, cfg, reqs, ep, device="cuda")
    for toks, launches, stats in ranks:
        assert toks == want
        assert launches == one_rank and launches[
            "expert_quant_matmul_grouped"] > 0
        assert stats["compiles"] == 0 and stats["mesh"] == {"data": 1,
                                                            "model": 4}


def test_cuda_lint_scopes_equal_launches():
    """The reduced OLMoE's admission wave and 4-step decode chunk, traced
    on the card: every rule clean, kernel calls in the trace equal to the
    launch counters, 3 K1 a layer and step."""
    dev = _need_cuda()
    from repro_torch.analysis import count_kernel_calls
    from repro_torch.analysis import lint as tlint
    from repro_torch.configs import get_config

    cfg = tlint._mix_cfg(get_config("olmoe_1b_7b").reduced(), "mixed")
    params, qparams = tlint._state(cfg, dev)
    forbidden = tlint.forbidden_shapes_from_qparams(qparams)
    for phase, program in (("admission", tlint._admission_program),
                           ("decode_chunk", tlint._decode_program)):
        fn, args, steps = program(cfg, params, qparams, dev)
        fn(*args)                            # builds the kernels
        torch.cuda.synchronize()
        kmod.reset_launch_counts()
        target = tlint.trace_target(f"reduced/{phase}", cfg, phase, fn,
                                    args, steps, forbidden=forbidden,
                                    device="cuda")
        torch.cuda.synchronize()
        assert not tlint.lint_targets([target])
        launched = dict(kmod.LAUNCHES)
        assert count_kernel_calls(target.trace) == sum(launched.values())
        assert launched["expert_quant_matmul_grouped"] == 3 * steps


def test_cuda_lint_kernel_resources_equal_the_mirror():
    """Each instantiation's attributes on the card: the dynamic shared
    memory its launcher requests equals the Python mirror, within the
    block budget, at most 255 registers, no local memory."""
    _need_cuda()
    from repro_torch.analysis.resources import INSTANTIATIONS, \
        SMEM_BUDGET_BYTES, card_resources

    for lib in INSTANTIATIONS:
        for row in card_resources(lib):
            assert row["requested_smem"] == row["mirror_smem"], row
            assert row["static_smem"] + row["requested_smem"] <= \
                SMEM_BUDGET_BYTES["sm_90a"], row
            assert not row["resources"].problems(), row
