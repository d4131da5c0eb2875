#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU. Run from the repository root: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and passed over):
  0. build — every CUDA kernel from ``src/repro_torch/kernels/*/csrc``
     (one nvcc per source, all started together), with ptxas's report;
     fails if any of K1-K5 (all on the tensor cores) spills;
  1. kernels — K1 (``expert_quant_matmul_grouped``) and K2
     (``expert_quant_matmul``) at OLMoE-1B-7B shapes, "4/2" and "4/0"
     (K2 at the 512- and 64-token solo admissions; both also with f32
     activations), held against their plain PyTorch versions on the same
     CUDA inputs; times (CUDA events, median; and the device time of the
     kernels alone under torch.profiler), bounds, plain and library
     times;
  2. kernel API — K3 (``quant_matmul``) at OLMoE-1B-7B's dense projection
     shape (also with f32 activations at M 512) and K4 + K5
     (``flash_fwd``, ``key_mass``) at its full attention width, f32 and
     bf16, held against their plain versions and timed as in phase 1;
     then the public entry points ``repro_torch.kernels.quant_matmul`` and
     ``flash_attention_with_scores`` on one layer of a full-width
     OLMoE-1B-7B and a 512-token prompt, with the launch counts of K3-K5
     read around these calls: the op's mass must equal the model's own
     Eq. 1 importance from ``attention_train``;
  3. reference — on a reduced f32 OLMoE, the engine on the card against
     the plain path on the CPU: greedy tokens and every request's modeled
     edge numbers (TTFT, TPOT, cache stats, weight bytes) equal exactly in
     "4/2" and "4/0"; seeded sampled tokens equal, and a sampled request's
     solo ``generate`` equals its batch row (on the card the decode chunks
     run as CUDA graph replays);
  4. serve — full-width OLMoE-1B-7B ("4/2", random weights from a seeded
     CUDA generator, quantized on the card): a warm run of
     ``generate_batch`` over 8 ragged requests on 4 slots and one
     ``generate`` captures the compiled decode chunk's keys (its host
     syncs are reported apart); then the same calls again, counted: the
     launch counts of K1 and K2 are read around them and checked. Printed:
     each request's modeled TTFT/TPOT under ``modeled_edge_<profile>`` (the
     cost model's edge device, not the card), the modeled cache hit rate,
     the replay's host seconds and the host syncs of the batch; then four
     seeded sampled requests against the same four greedy (wall, decode
     ms per step, host syncs). Then the compiled chunk: the graph gate
     (the same 16-step chunk from a copy of the same state, eager
     ``decode_many_batched`` against the graph replay: tokens, masks,
     done and emitted equal, greedy and sampled; eager and replay ms per
     step; the K1 kernels a replay runs under torch.profiler), one
     request profiled with graphs and eager, and every captured key
     replayed once under torch.profiler with its rows frozen (right after
     the counted runs for their keys, at the end for the rest): the port's
     kernels the replay ran must equal the counts each replay adds to the
     launch counters, in the ``graph:`` line.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel, and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when there is no CUDA device or when the
repository's sources are not beside this file.
"""
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TC_FLOP_PER_S = 989e12         # H100 SXM bf16 dense tensor cores
TIMED_RUNS = 25
# kernel -> (CUDA source, the Pallas function it replaces as file:line, the
# one PyTorch call timed beside it as "library_ms" or None)
KERNELS = {
    "expert_quant_matmul_grouped": (
        "src/repro_torch/kernels/quant_matmul/csrc/"
        "expert_quant_matmul_grouped.cu",
        "src/repro/kernels/quant_matmul/expert_quant_matmul.py:271",
        "bf16 torch.bmm on weights dequantized beforehand"),
    "expert_quant_matmul": (
        "src/repro_torch/kernels/quant_matmul/csrc/expert_quant_matmul.cu",
        "src/repro/kernels/quant_matmul/expert_quant_matmul.py:158",
        "bf16 torch.bmm on weights dequantized beforehand"),
    "quant_matmul": (
        "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu",
        "src/repro/kernels/quant_matmul/quant_matmul.py:78",
        "bf16 torch.matmul on weights dequantized beforehand"),
    "flash_fwd": (
        "src/repro_torch/kernels/attn_scores/csrc/flash_fwd.cu",
        "src/repro/kernels/attn_scores/attn_scores.py:103",
        "scaled_dot_product_attention(is_causal=True) in the inputs' "
        "dtype; it returns no lse"),
    "key_mass": (
        "src/repro_torch/kernels/attn_scores/csrc/key_mass.cu",
        "src/repro/kernels/attn_scores/attn_scores.py:141", None),
}
# launch counter -> its kernel's symbol (a substring of the profiler's key)
SYMBOLS = {"expert_quant_matmul_grouped": "eqm_mma::grouped_kernel",
           "expert_quant_matmul": "eqm_mma::expert_kernel",
           "quant_matmul": "qm_mma::dense_",
           "flash_fwd": "attn::flash_fwd_kernel",
           "key_mass": "attn::key_mass_kernel"}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _device_ms(fn, runs: int = 5):
    """Device time of one call of ``fn``: the self time of the CUDA kernels
    it launches under torch.profiler, over ``runs`` calls, per call. Unlike
    ``_median_ms`` (CUDA events around one call) it leaves out the host's
    time before the launch, which at S 512 is of the kernels' order. A
    trace now and then comes back without the kernels: it is taken again,
    and after three empty ones the time is None (not measured), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        if busy_us > 0:
            return busy_us / runs / 1e3
    return None


def _median_ms(fn, runs: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


# ------------------------------------------------------------------ kernels


def _kernel_cases(cfg, dev):
    """K1/K2 cases at the main path's shapes; returns per-kernel records."""
    import numpy as np
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.layers.moe import _capacity
    from repro_torch.quant.qtensor import MixedPrecisionWeights
    from repro_torch.quant.quantize import dequantize_tensor

    e, gs = cfg.num_experts, cfg.dymoe.group_size
    cap_solo = _capacity(cfg, 512)                       # 80
    cap_64 = _capacity(cfg, 64)                          # 10
    cap_1 = _capacity(cfg, 1)                            # 1: one token
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rng_new = np.random.default_rng(10)
    gen_new = torch.Generator(device=dev).manual_seed(10)
    rng_dec = np.random.default_rng(12)
    gen_dec = torch.Generator(device=dev).manual_seed(12)
    shapes = {"gate_up": (cfg.d_model, cfg.expert_d_ff),   # (K, N)
              "down": (cfg.expert_d_ff, cfg.d_model)}
    stores = {}
    for name, (k, n) in shapes.items():
        w = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
        mp = MixedPrecisionWeights.build(w.to(torch.bfloat16), 4, 2, gs)
        deq = {p: dequantize_tensor(q.packed, q.scales, q.bits, gs,
                                    torch.bfloat16)
               for p, q in (("high", mp.high), ("low", mp.low))}
        stores[name] = (mp, deq)
        del w

    def qbytes(q, experts):
        return experts * (q.packed[0].numel() + q.scales[0].numel() * 4)

    records = {"expert_quant_matmul_grouped": [], "expert_quant_matmul": []}
    for name, (k, n) in shapes.items():
        mp, deq = stores[name]
        for mix in ("4/2", "4/0"):
            lo = mp.low if mix == "4/2" else None
            lo_p = lo.packed if lo is not None else None
            lo_s = lo.scales if lo is not None else None
            # ---- K1: decode regions (cap 4, 8) and an admission wave with
            # bf16 x (the full-width model's dtype); gate/up "4/2" also
            # with f32 x and out (what a model in f32 runs)
            k1_cases = [("decode", 4, torch.bfloat16),
                        ("decode", 8, torch.bfloat16),
                        ("wave", 4 * cap_solo, torch.bfloat16)]
            if name == "gate_up" and mix == "4/2":
                k1_cases += [("decode", 4, torch.float32),
                             ("wave", 4 * cap_solo, torch.float32)]
            for region, cap, xdt in k1_cases:
                m = 2 * cap if lo is not None else cap
                counts_h = rng.integers(0, cap + 1, (e, 2)).astype(np.int32)
                counts_h[0, 0], counts_h[1, 0] = 0, cap   # empty and full
                if lo is None:
                    counts_h[:, 1] = 0
                x = torch.randn((e, m, k), generator=gen, device=dev
                                ).to(xdt)
                for i in range(e):       # the dispatch's zero-fill contract
                    x[i, counts_h[i, 0]:cap] = 0
                    if lo is not None:
                        x[i, cap + counts_h[i, 1]:] = 0
                counts = torch.from_numpy(counts_h).to(dev)
                args = (x, mp.high.packed, mp.high.scales, lo_p, lo_s,
                        counts)
                kw = dict(cap_hi=cap, hi_bits=4, lo_bits=2 if lo else 0,
                          group_size=gs)
                plain = km.PLAIN["expert_quant_matmul_grouped"]
                el = x.element_size()    # x and the timed out: one dtype
                got32 = km.expert_quant_matmul_grouped_cuda(
                    *args, out_dtype=torch.float32, **kw)
                ref32 = plain(*args, out_dtype=torch.float32, **kw)
                got = km.expert_quant_matmul_grouped_cuda(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                err = _check(got32, ref32, got, ref)
                kw["out_dtype"] = xdt
                for i in range(e):
                    assert not got[i, counts_h[i, 0]:cap].any(), "dead hi"
                    if lo is not None:
                        assert not got[i, cap + counts_h[i, 1]:].any(), \
                            "dead lo"
                wm = np.minimum(counts_h, [cap, cap if lo is not None
                                           else 0])
                live_rows = int(wm.sum())
                n_hi = int((wm[:, 0] > 0).sum())
                n_lo = int((wm[:, 1] > 0).sum())
                nbytes = (qbytes(mp.high, n_hi)
                          + (qbytes(lo, n_lo) if lo is not None else 0)
                          + live_rows * k * el + e * m * n * el)
                flops = 2.0 * live_rows * k * n
                w_cat = (torch.cat([deq["high"], deq["low"]])
                         if lo is not None else deq["high"]).to(xdt)
                xs = x.reshape(e, 2, cap, k).transpose(0, 1).reshape(
                    2 * e, cap, k) if lo is not None else x
                records["expert_quant_matmul_grouped"].append(_time_case(
                    f"{name} {mix} {region} cap={cap}"
                    + (" x f32" if xdt == torch.float32 else ""),
                    lambda: km.expert_quant_matmul_grouped_cuda(*args, **kw),
                    lambda: plain(*args, **kw),
                    lambda: torch.bmm(xs, w_cat), err, nbytes, flops))
                del w_cat
            # ---- K2: solo admission prefill, M = _capacity(cfg, 512), and
            # the profiled 64-token request's, M = _capacity(cfg, 64); gate/up
            # "4/2" also with f32 x and out (the reference phase's model)
            k2_cases = [(cap_solo, torch.bfloat16), (cap_64, torch.bfloat16)]
            if name == "gate_up" and mix == "4/2":
                k2_cases.append((cap_solo, torch.float32))
            if mix == "4/2":     # generate_reference's decode: M 1
                k2_cases.append((cap_1, torch.bfloat16))
            for i, (m, xdt) in enumerate(k2_cases):
                # added cases draw from generators of their own, so the
                # first case's inputs and all later cases' stay as they were
                g, r = ((gen, rng) if i == 0 else (gen_dec, rng_dec)
                        if m == cap_1 else (gen_new, rng_new))
                x = torch.randn((e, m, k), generator=g, device=dev).to(xdt)
                crit_h = (r.random(e) < 0.5).astype(np.int32)
                crit = torch.from_numpy(crit_h).to(dev)
                args = (x, mp.high.packed, mp.high.scales, lo_p, lo_s, crit)
                kw = dict(hi_bits=4, lo_bits=2 if lo else 0, group_size=gs)
                plain = km.PLAIN["expert_quant_matmul"]
                el = x.element_size()    # x and the timed out: one dtype
                got32 = km.expert_quant_matmul_cuda(
                    *args, out_dtype=torch.float32, **kw)
                ref32 = plain(*args, out_dtype=torch.float32, **kw)
                got = km.expert_quant_matmul_cuda(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                err = _check(got32, ref32, got, ref)
                kw["out_dtype"] = xdt
                if lo is None:
                    assert not got[crit_h == 0].any(), "4/0 sub-critical not 0"
                n_run = int(crit_h.sum()) if lo is None else e
                nbytes = (qbytes(mp.high, int(crit_h.sum()))
                          + (qbytes(lo, e - int(crit_h.sum())) if lo else 0)
                          + n_run * m * k * el + e * m * n * el)
                flops = 2.0 * n_run * m * k * n
                w_sel = torch.where(crit.bool()[:, None, None], deq["high"],
                                    deq["low"] if lo is not None
                                    else torch.zeros_like(deq["high"])
                                    ).to(xdt)
                records["expert_quant_matmul"].append(_time_case(
                    f"{name} {mix} {'decode' if m == cap_1 else 'solo'} M={m}"
                    + (" x f32" if xdt == torch.float32 else ""),
                    lambda: km.expert_quant_matmul_cuda(*args, **kw),
                    lambda: plain(*args, **kw),
                    lambda: torch.bmm(x, w_sel), err, nbytes, flops))
                del w_sel
    return records


def _check(got32, ref32, got, ref) -> float:
    """f32 out: |Δ| <= 5e-4·(1 + |ref|) against the plain version (the
    kernel sums K in another order than the library matmul); bf16 out (the
    path's dtype): exactly the kernel's f32 result rounded to bf16, as the
    plain version's bf16 out is its f32 result rounded. Returns max |Δ|."""
    import torch
    d32 = (got32 - ref32).abs()
    assert torch.all(d32 <= 5e-4 * (1 + ref32.abs())), \
        f"kernel vs plain (f32 out): max |d| {d32.max().item()}"
    assert torch.equal(got, got32.to(got.dtype)), "bf16 out != bf16(f32 out)"
    assert torch.equal(ref, ref32.to(ref.dtype))
    return float(d32.max().item())


def _time_case(label, kernel, plain, library, err, nbytes, flops):
    """One kernel case: CUDA-event medians of the kernel, its plain version
    and the library call, their device times, and the least time the card
    could take.

    Every kernel's products run on the bf16 tensor cores (K1-K3:
    activations and integer codes of at most 8 bits; K4/K5: q, k, v and
    the probabilities), so ``bound_ms`` (also written as
    ``tc_bound_ms``) counts the FLOPs at the bf16 dense rate. For f32
    inputs the same count at that rate is a lower limit too: an f32
    product there takes several bf16 planes. The f32 CUDA-core figure,
    which each kernel was held to before it reached the tensor cores,
    stays as ``f32_core_bound_ms``."""
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    f32_o = flops / F32_FLOP_PER_S * 1e3
    bound_o = flops / TC_FLOP_PER_S * 1e3
    rec = dict(case=label, max_abs_err=err,
               ms=_median_ms(kernel, TIMED_RUNS),
               plain_ms=_median_ms(plain, 5, warmup=1),
               library_ms=(_median_ms(library, 10) if library is not None
                           else None),
               device_ms=_device_ms(kernel),
               library_device_ms=(_device_ms(library)
                                  if library is not None else None),
               bound_ms=max(bound_b, bound_o),
               bound_by="bytes" if bound_b >= bound_o else "operations",
               bytes=nbytes, flops=flops)
    rec["tc_bound_ms"] = rec["bound_ms"]
    rec["f32_core_bound_ms"] = max(bound_b, f32_o)
    print("  " + json.dumps(rec), flush=True)
    return rec


# -------------------------------------------------------------- kernel API


def _attn_check(got, ref, what) -> float:
    """f32 attention outputs: |Δ| <= 1e-4·(1 + |ref|) against the plain
    version (the kernels sum in another order). Returns max |Δ|."""
    import torch
    d = (got - ref).abs()
    assert torch.all(d <= 1e-4 * (1 + ref.abs())), \
        f"{what}: kernel vs plain max |d| {d.max().item()}"
    return float(d.max().item())


def _api_cases(cfg, dev):
    """K3 at the dense projection shape (K = N = d_model, as wq/wo) and
    K4 + K5 at full attention width, against their plain versions on the
    same CUDA inputs; returns per-kernel records."""
    import torch
    from repro_torch.kernels.attn_scores import attn_scores as am
    from repro_torch.kernels.quant_matmul import quant_matmul as qm
    from repro_torch.quant.qtensor import QuantizedTensor
    from repro_torch.quant.quantize import dequantize_tensor

    gen = torch.Generator(device=dev).manual_seed(1)
    gen_new = torch.Generator(device=dev).manual_seed(11)   # added cases
    k = n = cfg.d_model
    gs = cfg.dymoe.group_size
    records = {"quant_matmul": [], "flash_fwd": [], "key_mass": []}
    plain = qm.PLAIN["quant_matmul"]
    for bits in (4, 2, 8):
        w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
             ).to(torch.bfloat16)
        qt = QuantizedTensor.quantize(w, bits, gs)
        w_deq = dequantize_tensor(qt.packed, qt.scales, bits, gs,
                                  torch.bfloat16)
        # bf16 x at M 1, 16, 512; 4-bit also f32 x and out at M 512
        cases = [(m, torch.bfloat16, gen) for m in (1, 16, 512)]
        if bits == 4:
            cases.append((512, torch.float32, gen_new))
        for m, xdt, g in cases:
            kw = dict(bits=bits, group_size=gs)
            x = torch.randn((m, k), generator=g, device=dev).to(xdt)
            args = (x, qt.packed, qt.scales)
            got32 = qm.quant_matmul_cuda(*args, out_dtype=torch.float32, **kw)
            ref32 = plain(*args, out_dtype=torch.float32, **kw)
            got = qm.quant_matmul_cuda(*args, **kw)
            ref = plain(*args, **kw)
            torch.cuda.synchronize()
            err = _check(got32, ref32, got, ref)
            kw["out_dtype"] = xdt
            el = x.element_size()
            nbytes = (qt.packed.numel() + qt.scales.numel() * 4 + m * k * el
                      + m * n * el)
            w_lib = w_deq.to(xdt)
            records["quant_matmul"].append(_time_case(
                f"{bits}-bit K={k} N={n} M={m}"
                + (" x f32" if xdt == torch.float32 else ""),
                lambda: qm.quant_matmul_cuda(*args, **kw),
                lambda: plain(*args, **kw),
                lambda: torch.matmul(x, w_lib), err, nbytes,
                2.0 * m * k * n))
    h, d = cfg.num_heads, cfg.head_dim
    # f32 at two lengths, and bf16 as the model's layer hands them over
    # (at 4096 too: against SDPA in bf16, which rounds P to bf16)
    for s, dt in ((512, torch.float32), (4096, torch.float32),
                  (512, torch.bfloat16), (4096, torch.bfloat16)):
        q, kk, v = (torch.randn((h, s, d), generator=gen, device=dev
                                ).to(dt) for _ in range(3))
        out, lse = am.flash_fwd_cuda(q, kk, v, causal=True)
        mass = am.key_mass_cuda(q, kk, lse, causal=True)
        torch.cuda.synchronize()
        rout, rlse = am.PLAIN["flash_fwd"](q, kk, v, causal=True)
        rmass = am.PLAIN["key_mass"](q, kk, lse, causal=True)
        err4 = max(_attn_check(out, rout, f"flash_fwd out S={s}"),
                   _attn_check(lse, rlse, f"flash_fwd lse S={s}"))
        err5 = _attn_check(mass, rmass, f"key_mass S={s}")
        sums = mass.sum(dim=1)
        assert torch.all((sums - s).abs() <= 1e-5 * s), \
            f"key_mass: head sums {sums.tolist()} != S={s}"
        del rout, rlse, rmass
        pairs = s * (s + 1) / 2                  # visible (query, key) pairs
        el = q.element_size()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        label = f"causal H={h} S={s} D={d} {str(dt)[6:]}"
        records["flash_fwd"].append(_time_case(
            label, lambda: am.flash_fwd_cuda(q, kk, v, causal=True),
            lambda: am.PLAIN["flash_fwd"](q, kk, v, causal=True),
            lambda: sdpa(q[None], kk[None], v[None], is_causal=True),
            err4, h * s * (3 * d * el + 4 * d + 4), 4.0 * h * d * pairs))
        records["key_mass"].append(_time_case(
            label, lambda: am.key_mass_cuda(q, kk, lse, causal=True),
            lambda: am.PLAIN["key_mass"](q, kk, lse, causal=True),
            None, err5, h * s * (2 * d * el + 8), 2.0 * h * d * pairs))
        del q, kk, v, out, lse, mass
    torch.cuda.empty_cache()
    return records


def _api_phase(cfg, dev):
    """The public kernel entry points on one layer of a full-width
    OLMoE-1B-7B (seeded CUDA generator) and one 512-token prompt with no
    padding: ``quant_matmul`` projects the layer's normed hidden states
    through its 4-bit ``wq`` (prefill rows and one decode row), and
    ``flash_attention_with_scores`` takes the layer's q/k/v. Its mass must
    equal ``attention_train``'s Eq. 1 importance. Returns the K3-K5 launch
    counts of these calls."""
    import dataclasses

    import torch
    from repro_torch.kernels import flash_attention_with_scores, \
        quant_matmul
    from repro_torch.kernels.attn_scores import attn_scores as am
    from repro_torch.kernels.quant_matmul import quant_matmul as qm
    from repro_torch.models.layers import attention as tattn
    from repro_torch.models.layers.norms import rmsnorm
    from repro_torch.models.model import _index_tree, init_params
    from repro_torch.quant.qtensor import QuantizedTensor

    cfg1 = dataclasses.replace(cfg, num_layers=1)
    params = init_params(cfg1, torch.Generator(device=dev).manual_seed(2))
    s = 512
    tokens = torch.randint(1, cfg.vocab_size, (1, s), device=dev,
                           generator=torch.Generator(device=dev
                                                     ).manual_seed(3))
    lp = _index_tree(params["layers"], 0)
    hid = rmsnorm(lp["norm1"], params["embed"][tokens], cfg.norm_eps)
    qt = QuantizedTensor.quantize(lp["attn"]["wq"], cfg.dymoe.high_bits,
                                  cfg.dymoe.group_size)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None]
    q, k, v = tattn._project_qkv(lp["attn"], cfg1, hid, pos)
    _, imp, _ = tattn.attention_train(lp["attn"], cfg1, hid,
                                      want_token_importance=True)
    torch.cuda.synchronize()

    qm.reset_launch_counts()                       # main path starts here
    am.reset_launch_counts()
    y = quant_matmul(hid, qt, out_dtype=torch.float32)
    y1 = quant_matmul(hid[:, -1:], qt, out_dtype=torch.float32)
    _, mass = flash_attention_with_scores(
        q[0].reshape(cfg.num_heads, s, cfg.head_dim), k[0], v[0])
    torch.cuda.synchronize()
    launches = {**qm.LAUNCHES, **am.LAUNCHES}      # main path ends here

    plain = qm.PLAIN["quant_matmul"]
    kw = dict(bits=qt.bits, group_size=qt.group_size,
              out_dtype=torch.float32)
    ref = plain(hid[0], qt.packed, qt.scales, **kw)
    for got, want in ((y[0], ref), (y1[0], ref[-1:])):
        assert torch.all((got - want).abs() <= 5e-4 * (1 + want.abs())), \
            "quant_matmul entry point vs plain"
    err = _attn_check(mass, imp[0], "flash_attention_with_scores mass vs "
                      "attention_train importance")
    assert abs(float(mass.sum()) - s) <= 1e-5 * s
    print(f"api: olmoe_1b_7b layer 0, {s}-token prompt: quant_matmul "
          f"{tuple(y.shape)} + decode row; flash_attention_with_scores mass "
          f"== attention_train Eq. 1 importance (max |d| {err:.3g}); "
          f"launches {launches}", flush=True)
    return launches


# -------------------------------------------------------------- reference


def _reference_phase(dev):
    """The engine on the card against the plain path on the CPU for a
    reduced f32 OLMoE, in "4/2" and "4/0": greedy tokens equal, and every
    request's modeled edge numbers (TTFT, TPOT, cache stats, weight
    bytes: the host replay of the card's telemetry) equal exactly. Then a
    seeded sampled set (temperature 0.7, top_k 0 and 20, one greedy row):
    card tokens equal CPU tokens, and one sampled request's solo
    ``generate`` equals its batch row on the card."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, Request

    base = get_config("olmoe_1b_7b").reduced()
    params = init_params(base, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, base.vocab_size, int(s))], max_new_tokens=int(m))
        for s, m in ((9, 6), (17, 11), (5, 8), (12, 20))]
    modeled = ("ttft_s", "tpot_s", "cache_stats", "prefill_weight_bytes",
               "decode_weight_bytes_per_tok")
    for low_bits in (2, 0):
        cfg = dataclasses.replace(base, dymoe=dataclasses.replace(
            base.dymoe, low_bits=low_bits))
        cpu = DyMoEEngine(cfg, params, device="cpu").generate_batch(
            reqs, num_slots=2)
        gpu = DyMoEEngine(cfg, params, device=dev).generate_batch(
            reqs, num_slots=2)
        ct, gt = [r.tokens for r in cpu], [r.tokens for r in gpu]
        assert gt == ct, f"card tokens {gt} != CPU plain tokens {ct}"
        for i, (c, g) in enumerate(zip(cpu, gpu)):
            for f in modeled:
                assert getattr(g, f) == getattr(c, f), \
                    f"request {i} {f}: card {getattr(g, f)} != CPU " \
                    f"{getattr(c, f)}"
        print(f"reference: reduced olmoe f32 4/{low_bits}, {len(reqs)} "
              f"requests, card tokens == CPU plain tokens "
              f"({sum(map(len, gt))} tokens); modeled ttft/tpot, cache "
              f"stats, weight bytes == CPU (ttft_s "
              f"{[r.ttft_s for r in gpu]})", flush=True)
    sampled = [dataclasses.replace(r, temperature=t, top_k=k, seed=sd)
               for r, (t, k, sd) in zip(reqs, ((0.7, 0, 5), (0.7, 20, 6),
                                               (0.0, 0, None), (0.7, 0, 7)))]
    cpu_eng = DyMoEEngine(base, params, device="cpu")
    gpu_eng = DyMoEEngine(base, params, device=dev)
    ct = [r.tokens for r in cpu_eng.generate_batch(sampled, num_slots=2)]
    gt = [r.tokens for r in gpu_eng.generate_batch(sampled, num_slots=2)]
    greedy = [r.tokens for r in gpu_eng.generate_batch(reqs, num_slots=2)]
    assert gt == ct, f"sampled card tokens {gt} != CPU tokens {ct}"
    assert gt[2] == greedy[2] and gt[0] != greedy[0]
    solo = gpu_eng.generate(sampled[1]).tokens
    assert solo == gt[1], f"solo sampled {solo} != batch row {gt[1]}"
    print(f"reference: reduced olmoe f32 4/2, {len(sampled)} seeded requests"
          f" (temperature 0.7, top_k 0 / 20, one greedy): card tokens == CPU "
          f"tokens, solo generate == batch row", flush=True)
    _reference_session(base, params, dev)
    for r in (reqs[1], sampled[1]):
        c, g = cpu_eng.generate_reference(r), gpu_eng.generate_reference(r)
        assert g.tokens == c.tokens, \
            f"generate_reference card {g.tokens} != CPU {c.tokens}"
        for f in modeled:
            assert getattr(g, f) == getattr(c, f), \
                f"generate_reference {f}: card {getattr(g, f)} != CPU"
    print("reference: reduced olmoe f32 4/2 generate_reference (greedy, "
          "sampled): card tokens and modeled numbers == CPU", flush=True)


def _reference_session(cfg, params, dev):
    """One scripted open session on the reduced f32 OLMoE, EDF, with one
    ``device.dispatch``, one ``replay.chunk`` and one ``admit.alloc``
    fault, on the card and on the CPU: 4 bulk requests at 2 slots, two
    steps, then two urgent ones (priority 3: EDF preempts for them) and a
    late one after the rest drained. Every handle's tokens or typed error
    class, result flags and modeled numbers, and the session's health,
    must be equal."""
    import dataclasses

    import numpy as np
    from repro_torch.serving import DyMoEEngine, FaultInjector, FaultSpec, \
        Request

    def run(device):
        faults = FaultInjector([FaultSpec(site="device.dispatch", at=1),
                                FaultSpec(site="replay.chunk", at=2),
                                FaultSpec(site="admit.alloc", at=1)])
        eng = DyMoEEngine(cfg, params, faults=faults, device=device)
        rng = np.random.default_rng(4)

        def req(i, n, m):
            return Request(prompt_tokens=[int(v) for v in rng.integers(
                1, cfg.vocab_size, n)], max_new_tokens=m,
                request_id=f"r{i}")

        s = eng.serve(num_slots=2, slots_len=64, policy="edf")
        hs = [s.submit(req(i, n, 24)) for i, n in enumerate((9, 17, 5, 12))]
        for _ in range(2):               # slots busy, queue deep
            s.step()
        hs += [s.submit(dataclasses.replace(req(i, n, m), priority=3))
               for i, n, m in ((4, 8, 5), (5, 6, 7))]
        s.drain(cancel_queued=False)
        hs.append(s.submit(req(9, 7, 3)))
        s.drain(cancel_queued=False)
        health = dataclasses.asdict(s.health())
        fired = list(faults.fired)
        s.close()
        out = []
        for h in hs:
            assert h.done, f"{h.request_id} never resolved"
            if h.error is not None:
                out.append((h.request_id, type(h.error).__name__))
                continue
            r = h.result(drive=False)
            out.append((h.request_id, r.tokens, r.ttft_s, r.tpot_s,
                        r.cancelled, r.preempted, r.cache_stats,
                        r.prefill_weight_bytes,
                        r.decode_weight_bytes_per_tok))
        return out, health, fired

    cpu, gpu = run("cpu"), run(dev)
    assert gpu[2] == cpu[2] and len(gpu[2]) == 3, (gpu[2], cpu[2])
    assert gpu[1] == cpu[1], f"session health: card {gpu[1]} != CPU {cpu[1]}"
    assert gpu[0] == cpu[0], \
        f"session outcomes: card {gpu[0]} != CPU {cpu[0]}"
    errors = Counter(o[1] for o in gpu[0] if isinstance(o[1], str))
    print(f"reference: reduced olmoe f32 4/2 open session (EDF, faults "
          f"{[f[0] for f in gpu[2]]}): card == CPU — {len(gpu[0])} handles "
          f"({dict(errors)} typed), tokens, modeled numbers and health "
          f"{ {k: v for k, v in gpu[1].items() if v and k != 'last_fault'} }",
          flush=True)


# ------------------------------------------------------------------ serve


def _serve_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig, Request

    cfg = get_config("olmoe_1b_7b")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    engine = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=16),
                         device=dev)
    torch.cuda.synchronize()
    print(f"serve: olmoe_1b_7b {cfg.dymoe.high_bits}/{cfg.dymoe.low_bits} "
          f"init+quantize {time.perf_counter() - t0:.1f}s, "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, int(rng.integers(64, 513)))],
        max_new_tokens=int(rng.integers(16, 49))) for _ in range(8)]
    solo_req = reqs[3]

    torch.cuda.reset_peak_memory_stats()
    # the warm (cold-start) run: the compiled chunk captures the keys the
    # counted runs below meet; its host syncs (the captures') apart
    with warnings.catch_warnings(record=True) as warm_syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        warm = engine.generate_batch(reqs, num_slots=4)
        torch.cuda.synchronize()
        cold_wall = time.perf_counter() - t0
        cold_stats = dict(engine.last_stats)
        engine.generate(solo_req)
        torch.cuda.synchronize()
        cold_solo_stats = dict(engine.last_stats)
        torch.cuda.set_sync_debug_mode("default")

    km.reset_launch_counts()                       # main path starts here
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.perf_counter()
        out = engine.generate_batch(reqs, num_slots=4)
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode("default")
    batch_stats = dict(engine.last_stats)
    k1_batch = km.LAUNCHES["expert_quant_matmul_grouped"]
    k2_batch = km.LAUNCHES["expert_quant_matmul"]
    t0 = time.perf_counter()
    solo = engine.generate(solo_req)
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    launches = dict(km.LAUNCHES)                   # main path ends here
    solo_stats = dict(engine.last_stats)
    checked = set()          # the counted runs' keys, measured at replay
    replay_counts = _replay_counts(engine._decode_batched, checked)
    peak = torch.cuda.max_memory_allocated()
    assert [r.tokens for r in out] == [r.tokens for r in warm]
    assert batch_stats["compiles"] == 0 and solo_stats["compiles"] == 0, \
        "the counted runs met a key the warm run did not capture"
    sampling = _sampled_batch(engine, reqs[:4])
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    profiled = _profile_decode(engine, activities)
    graph = _graph_phase(engine, activities, profiled)
    replay_counts += _replay_counts(engine._decode_batched, checked)
    graph.update(serve_wall_cold_s=cold_wall, serve_wall_warm_s=batch_wall,
                 cold_batch=dict(compiles=cold_stats["compiles"],
                                 compile_s=cold_stats["compile_s"]),
                 cold_solo=dict(compiles=cold_solo_stats["compiles"],
                                compile_s=cold_solo_stats["compile_s"]),
                 host_syncs_in_warm_run=_sync_sites(warm_syncs),
                 replay_counts=replay_counts)

    n_tok = sum(len(r.tokens) for r in out)
    for r, q in zip(out, reqs):
        assert len(r.tokens) == q.max_new_tokens, (len(r.tokens), q)
        assert all(0 <= v < cfg.vocab_size for v in r.tokens)
    assert len(solo.tokens) == solo_req.max_new_tokens
    k1_expect = 3 * L * (batch_stats["decode_steps"]
                         + batch_stats["waves_batched"])
    assert k1_batch == k1_expect, (k1_batch, k1_expect, batch_stats)
    assert k2_batch == 3 * L * batch_stats["waves_solo"], (k2_batch,
                                                           batch_stats)
    k2_solo = launches["expert_quant_matmul"] - k2_batch
    k1_solo = launches["expert_quant_matmul_grouped"] - k1_batch
    assert k2_solo >= 3 * L and k1_solo == 3 * L * solo_stats["decode_steps"]
    profile_name = engine.ecfg.profile.name
    for r in out + [solo]:
        assert np.isfinite(r.ttft_s) and r.ttft_s > 0, r.ttft_s
        assert np.isfinite(r.tpot_s) and r.tpot_s > 0, r.tpot_s
    final = max((r.cache_stats for r in out),
                key=lambda c: c["hits"] + c["misses"])
    summary = dict(
        # outputs of the edge cost model (EngineConfig.profile), replayed
        # from this run's telemetry: NOT times of the card that ran it
        **{f"modeled_edge_{profile_name}": dict(
            ttft_s=[r.ttft_s for r in out], tpot_s=[r.tpot_s for r in out],
            prefill_weight_bytes=[r.prefill_weight_bytes for r in out],
            decode_weight_bytes_per_tok=[r.decode_weight_bytes_per_tok
                                         for r in out],
            cache_hit_rate=final["hits"] / (final["hits"] + final["misses"]),
            cache_stats=final)},
        replay_host_s=batch_stats["replay_s"],
        replay_share_of_wall=batch_stats["replay_s"] / batch_wall,
        replay_jobs=batch_stats["replay_jobs"],
        host_syncs_in_batch=_sync_sites(syncs),
        sampled=sampling,
        requests=len(reqs), prompt_tokens=[q.prompt_len for q in reqs],
        new_tokens=[len(r.tokens) for r in out], batch_wall_s=batch_wall,
        batch_decode_tok_per_s=(n_tok - len(reqs)) / batch_wall,
        wall_s=[r.wall_s for r in out],
        queue_wait_s=[r.queue_wait_s for r in out],
        decode_wall_s=[r.decode_wall_s for r in out], batch=batch_stats,
        solo_wall_s=solo_wall,
        solo_tokens=len(solo.tokens), solo=solo_stats,
        solo_matches_batch_row=solo.tokens == out[3].tokens,
        k1_launches=launches["expert_quant_matmul_grouped"],
        k2_launches=launches["expert_quant_matmul"],
        k1_expected_batch=k1_expect,
        max_memory_allocated_gib=peak / 2**30, profile=profiled)
    print("serve: " + json.dumps(summary), flush=True)
    print("graph: " + json.dumps(graph), flush=True)
    return launches, engine


def _session_phase(engine) -> dict:
    """The open session at full width on the serve phase's engine: 4 slots,
    ``slots_len`` 1024 (the serve phase's bucket, so the session reuses its
    decode state and graphs), EDF. Staggered submits: three bulk requests
    and one that is cancelled after its first chunk, a fourth bulk one into
    the freed slot, then an urgent request (priority 5; it preempts a bulk
    row, and its stream drives the session) and one with ``deadline_s=0``
    (shed). Run clean, then again with one ``device.dispatch`` fault (its
    retry runs a halved chunk, a new graph key). Every handle must resolve
    as expected, ``dispatch_retries`` must equal the faults injected, and
    the K1/K2 launches of the clean run must equal 3 x L x its decode steps,
    batched waves and captures' warm-up steps (K1) and solo waves (K2).
    Prints the ``session:`` line: step ms, the keys each run captured with
    their seconds, and the faulted run's tokens against the clean run's."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.serving import DeadlineExceeded, EDFPolicy, \
        FaultInjector, FaultSpec, Request

    cfg, L = engine.cfg, engine.cfg.num_layers
    rng = np.random.default_rng(21)

    def req(i, n, m, **kw):
        return Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, n)], max_new_tokens=m, request_id=f"s{i}",
            **kw)

    bulk = [req(i, n, 48) for i, n in enumerate((96, 180, 256, 400))]
    cancelled = req(4, 128, 40)
    urgent = req(5, 64, 16, priority=5)
    doomed = req(6, 32, 8, deadline_s=0.0)

    def run(faults):
        compiled = engine._decode_batched
        n0, s0 = compiled.compiles, compiled.compile_s
        before = {(st.num_slots, st.slots_len, k)
                  for st in compiled.states() for k in st.entries}
        engine.faults = faults
        s = engine.serve(num_slots=4, slots_len=1024, policy=EDFPolicy())
        walls = []
        inner = s.step

        def timed_step():
            t0 = time.perf_counter()
            more = inner()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            return more

        s.step = timed_step
        t0 = time.perf_counter()
        hs = [s.submit(r) for r in bulk[:3]] + [s.submit(cancelled)]
        s.step()                       # one wave of 4, one chunk
        hs[3].cancel()
        hs.append(s.submit(bulk[3]))
        s.step()                       # the cancelled slot to bulk[3]
        hs += [s.submit(urgent), s.submit(doomed)]
        streamed = [t for ev in hs[5].stream() for t in ev.tokens]
        s.drain(cancel_queued=False)
        wall = time.perf_counter() - t0
        health = s.health()
        stats = dict(s.stats)
        s.close()
        engine.faults = None
        return dict(handles=hs, wall=wall, walls=walls, health=health,
                    stats=stats, streamed=streamed,
                    compiles=compiled.compiles - n0,
                    compile_s=compiled.compile_s - s0,
                    keys=[dict(slots=st.num_slots, slots_len=st.slots_len,
                               num_steps=k[0], live_cap=k[1], sampled=k[2],
                               graph=e.graph is not None,
                               warmup_s=e.warmup_s, capture_s=e.capture_s)
                          for st in compiled.states()
                          for k, e in st.entries.items()
                          if (st.num_slots, st.slots_len, k) not in before])

    km.reset_launch_counts()           # the session path starts here
    clean = run(None)
    torch.cuda.synchronize()
    launches = dict(km.LAUNCHES)       # the session path ends here
    faulted = run(FaultInjector([FaultSpec(site="device.dispatch", at=2)]))
    out = {}
    for name, r in (("clean", clean), ("faulted", faulted)):
        bulk_h = [r["handles"][i] for i in (0, 1, 2, 4)]
        c_h, u_h, d_h = (r["handles"][i] for i in (3, 5, 6))
        res = {h.request_id: h.result(drive=False) for h in bulk_h}
        for h in bulk_h:
            assert len(res[h.request_id].tokens) == 48, h.request_id
            assert not res[h.request_id].cancelled
        rc = c_h.result(drive=False)
        assert rc.cancelled and 0 < len(rc.tokens) < 40, rc.tokens
        ru = u_h.result(drive=False)
        assert len(ru.tokens) == 16 and ru.preempted == 0
        assert r["streamed"] == ru.tokens, "urgent's stream != its tokens"
        assert isinstance(d_h.error, DeadlineExceeded)
        hl = r["health"]
        assert sum(x.preempted for x in res.values()) == 1 == hl.preemptions
        assert hl.deadline_shed == 1 and hl.dispatch_failures == 0
        assert hl.dispatch_retries == (1 if name == "faulted" else 0), hl
        assert hl.submitted == hl.completed == 7 and hl.status == "ok"
        st = r["stats"]
        out[name] = dict(
            wall_s=r["wall"], steps=len(r["walls"]), step_ms=r["walls"],
            step_ms_median=sorted(r["walls"])[len(r["walls"]) // 2],
            chunks=st["chunks"], decode_steps=st["decode_steps"],
            ms_per_decode_step=r["wall"] * 1e3 / st["decode_steps"],
            waves_batched=st["waves_batched"], waves_solo=st["waves_solo"],
            replay_s=st["replay_s"], compiles=r["compiles"],
            compile_s=r["compile_s"], keys_captured=r["keys"],
            preempted=[h.request_id for h in bulk_h
                       if res[h.request_id].preempted],
            cancelled_tokens=len(rc.tokens),
            health={k: v for k, v in dataclasses.asdict(hl).items()
                    if v and k != "last_fault"})
    cst = clean["stats"]
    # a capture's frozen warm-up step launches for real (once a new key)
    warm = sum(k["graph"] for k in clean["keys"])
    assert launches["expert_quant_matmul_grouped"] == 3 * L * (
        cst["decode_steps"] + cst["waves_batched"] + warm), (launches, cst)
    assert launches["expert_quant_matmul"] == 3 * L * cst["waves_solo"] > 0
    toks = {n: {h.request_id: h.result(drive=False).tokens
                for h in r["handles"] if h.error is None}
            for n, r in (("clean", clean), ("faulted", faulted))}
    out["faulted_tokens_equal_clean"] = {
        k: toks["faulted"][k] == v for k, v in toks["clean"].items()}
    out["launches_clean"] = launches
    print("session: " + json.dumps(out), flush=True)
    return launches


def _reference_full(engine) -> dict:
    """``generate_reference`` at full width on the serve phase's engine: a
    64-token prompt, 33 new tokens (two 16-step ``decode_many`` chunks,
    eager), after one warm call. Its K2 launches must be 3 x L a prefill
    and a decode step (M 1 per expert at decode), with no K1; printed with
    ms per token and whether its tokens equal ``generate``'s."""
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.serving import Request

    L = engine.cfg.num_layers
    req = Request(prompt_tokens=list(range(101, 165)), max_new_tokens=33)
    engine.generate_reference(req)                 # warm
    torch.cuda.synchronize()
    km.reset_launch_counts()           # the reference path starts here
    t0 = time.perf_counter()
    res = engine.generate_reference(req)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(km.LAUNCHES)       # the reference path ends here
    assert launches["expert_quant_matmul"] == 3 * L * 33, launches
    assert launches["expert_quant_matmul_grouped"] == 0, launches
    assert len(res.tokens) == 33
    gen = engine.generate(req)
    # where its time goes: host syncs by source line, then one run under
    # torch.profiler (device busy, kernels, the host's heaviest ops)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        engine.generate_reference(req)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("default")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate_reference(req)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    busy_ms = sum(e.self_device_time_total for e in cuda) / 1e3
    summary = dict(
        prompt=req.prompt_len, new_tokens=len(res.tokens), wall_s=wall,
        decode_wall_s=res.decode_wall_s,
        ms_per_token=res.decode_wall_s * 1e3 / (len(res.tokens) - 1),
        host_syncs=_sync_sites(caught),
        traced=dict(wall_ms=traced * 1e3, device_busy_ms=busy_ms,
                    idle_share=1 - busy_ms / (traced * 1e3),
                    kernels_per_token=sum(e.count for e in cuda) / 33,
                    host_top=[dict(name=e.key[:50], count=e.count,
                                   self_ms=e.self_cpu_time_total / 1e3)
                              for e in host]),
        k2_launches=launches["expert_quant_matmul"],
        tokens_equal_generate=gen.tokens == res.tokens,
        tokens_agree_generate=sum(a == b for a, b in zip(gen.tokens,
                                                         res.tokens)),
        modeled_ttft_s=res.ttft_s, modeled_tpot_s=res.tpot_s)
    print("reference_full: " + json.dumps(summary), flush=True)
    return launches


def _replay_counts(compiled, checked: set) -> list:
    """Every compiled key of ``compiled``'s decode states not yet in
    ``checked``, replayed once under torch.profiler on its own state with
    every row frozen (the caches do not change): the port's kernels the
    replay ran, counted by symbol (``SYMBOLS``), must equal the counts the
    key adds to the launch counters at each replay (its capture's). A
    trace that shows fewer kernels than counted is taken again, up to three
    times (the profiler now and then drops a few kernel records of a graph
    replay: once 762 of 768); one that shows more fails at once, as does a
    key whose three traces all fall short. Adds the keys to ``checked``;
    returns one row a key, with the traces it took."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows = []
    for st in compiled.states():
        b, dev = st.num_slots, st.inputs["tokens"].device
        for key, entry in list(st.entries.items()):
            ident = (b, st.slots_len, *key)
            if ident in checked:
                continue
            steps, cap, sampled = key
            host = dict(done=np.ones(b, bool), n_emitted=np.zeros(b, np.int32),
                        limits=np.ones(b, np.int32),
                        eos_tokens=np.full(b, -1, np.int32))
            if sampled:
                host.update(rng_keys=np.zeros((b, 2), np.int64),
                            temperatures=np.zeros(b, np.float32),
                            top_ks=np.zeros(b, np.int64))
            tok = torch.zeros(b, dtype=torch.int32, device=dev)
            assert set(entry.launches) == set(SYMBOLS), entry.launches
            traces = []
            while len(traces) < 3:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    compiled(st, tok, num_steps=steps, live_cap=cap, **host)
                    torch.cuda.synchronize()
                kernels = [e for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA]
                ran = {name: sum(e.count for e in kernels if sym in e.key)
                       for name, sym in SYMBOLS.items()}
                traces.append(ran)
                assert all(ran[k] <= entry.launches[k] for k in ran), \
                    f"key {ident}: the replay ran {ran}, counted " \
                    f"{entry.launches}"
                if ran == entry.launches:
                    break
            assert ran == entry.launches, \
                f"key {ident}: the replays ran {traces}, counted " \
                f"{entry.launches}"
            checked.add(ident)
            rows.append(dict(slots=b, slots_len=st.slots_len, num_steps=steps,
                             live_cap=cap, sampled=sampled, kernels=ran,
                             traces=len(traces)))
    return rows


def _sync_sites(caught) -> dict:
    """Where a run synchronized with the card: file:line -> count, from
    the warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (not its
    one-time notice that the mode is a prototype)."""
    return dict(Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                        if "synchroniz" in str(w.message)
                        and "prototype" not in str(w.message)))


def _sampler_step(dev, v) -> dict:
    """What one sampled decode step adds, alone: the per-row keys folded
    with the rows' counts and ``sample_token_rows`` over 4 rows of a
    ``v``-token vocabulary (temperature 0.7, top_k 0 and 20), against the
    greedy step's argmax. Host ms per call (50 calls, one sync at the
    end: the eager dispatch a decode step pays) and device ms."""
    import torch
    from repro_torch.serving.sampler import PRNGKey, fold_in, \
        sample_token_rows
    g = torch.Generator(device=dev).manual_seed(5)
    logits = torch.randn((4, v), generator=g, device=dev) * 3
    keys = fold_in(PRNGKey(9).to(dev).expand(4, 2),
                   torch.arange(4, device=dev))
    temps = torch.full((4,), 0.7, device=dev)
    topks = torch.tensor([0, 20, 0, 20], device=dev)
    emitted = torch.arange(4, dtype=torch.int32, device=dev)

    def sampled():
        return sample_token_rows(logits, fold_in(keys, emitted), temps,
                                 topks)

    def greedy():
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def host_ms(fn, n=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    return dict(vocab=v, rows=4, sampled_host_ms=host_ms(sampled),
                sampled_device_ms=_device_ms(sampled),
                greedy_host_ms=host_ms(greedy),
                greedy_device_ms=_device_ms(greedy))


def _sampled_batch(engine, reqs) -> dict:
    """Four seeded sampled requests (temperature 0.7, top_k 0 and 20) on 4
    slots against the same four served greedily: one warm run of each
    (capturing their keys), then in turns G S S G: each
    run's wall, decode ms per step (the longest request's decode wall
    over the steps dispatched) and, for the first sampled run, where it
    synchronized with the card; then the sampling step alone
    (``_sampler_step``)."""
    import dataclasses
    import warnings as _w

    import torch
    sampled = [dataclasses.replace(r, temperature=0.7, top_k=(0, 20)[i % 2],
                                   seed=100 + i) for i, r in enumerate(reqs)]
    warm = []                   # capture both modes' keys first
    for batch in (reqs, sampled):
        t0 = time.perf_counter()
        engine.generate_batch(batch, num_slots=4)
        torch.cuda.synchronize()
        warm.append(dict(wall_s=time.perf_counter() - t0,
                         compiles=engine.last_stats["compiles"],
                         compile_s=engine.last_stats["compile_s"]))
    runs, syncs_sampled = [], None
    for kind in ("greedy", "sampled", "sampled", "greedy"):
        batch = sampled if kind == "sampled" else reqs
        with _w.catch_warnings(record=True) as caught:
            _w.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            out = engine.generate_batch(batch, num_slots=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
        if kind == "sampled" and syncs_sampled is None:
            syncs_sampled = _sync_sites(caught)
        steps = engine.last_stats["decode_steps"]
        assert engine.last_stats["compiles"] == 0, engine.last_stats
        runs.append(dict(kind=kind, wall_s=wall, decode_steps=steps,
                         decode_ms_per_step=1e3 * max(
                             r.decode_wall_s for r in out) / steps,
                         tokens=[len(r.tokens) for r in out]))
        for r, q in zip(out, batch):
            assert len(r.tokens) == q.max_new_tokens, (len(r.tokens), q)
    return dict(warm=warm, runs=runs, host_syncs_in_sampled=syncs_sampled,
                step=_sampler_step(engine.device, engine.cfg.vocab_size))


def _profile_decode(engine, activities) -> dict:
    """Where the time of one request goes: a 64-token solo admission and
    one 16-step decode chunk (warm: its chunk key captured), timed once
    plain and once under torch.profiler. Device busy = the sum of the CUDA kernels' device time
    (one stream, so they do not overlap); idle share = 1 - busy / wall;
    the eight largest kernels by device time, and every instantiation of
    the port's packed matmuls (K1, K2) with its time and count."""
    import torch
    from repro_torch.serving import Request
    from torch.profiler import profile

    req = Request(prompt_tokens=list(range(1, 65)), max_new_tokens=17)
    engine.generate(req)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(req)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        engine.generate(req)
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    # the port's own kernels (K1-K3 instantiations), wherever they rank
    ours = {e.key.split("(")[0].removeprefix("void "): dict(
        ms=e.self_device_time_total / 1e3, count=e.count)
        for e in kernels if "eqm_mma::" in e.key or "qm_mma::" in e.key}
    return dict(
        wall_ms=wall * 1e3, decode_ms_per_step=res.decode_wall_s * 1e3 / 16,
        traced_wall_ms=wall_traced * 1e3, device_busy_ms=busy_us / 1e3,
        idle_share=1 - busy_us / 1e6 / wall_traced,
        kernel_launches=sum(e.count for e in kernels), port_kernels=ours,
        # the host's launch calls (kernels, graphs) as the trace saw them
        runtime_launches={e.key: e.count for e in events
                          if e.device_type == torch.autograd.DeviceType.CPU
                          and "Launch" in e.key},
        top_kernels=[dict(name=e.key[:60], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in top])


def _graph_phase(engine, activities, profiled) -> dict:
    """The compiled decode chunk on full-width OLMoE-1B-7B: the profiled
    request of ``_profile_decode`` again with the chunk run eagerly (the
    same static-buffer protocol without graphs) beside its graph run
    (``profiled``), the graph gate (``_graph_gate``), and every graph the
    engine captured in this run, with its warm-up and capture seconds, and
    the bytes of their shared pool."""
    from repro_torch.serving.compiled import CompiledDecodeChunk

    compiled = engine._decode_batched
    engine._decode_batched = CompiledDecodeChunk(engine, graphs=False)
    try:
        eager = _profile_decode(engine, activities)
    finally:
        engine._decode_batched = compiled
    gate = _graph_gate(engine)
    keep = ("wall_ms", "decode_ms_per_step", "traced_wall_ms",
            "device_busy_ms", "idle_share", "kernel_launches",
            "runtime_launches")
    captured = [dict(slots=st.num_slots, slots_len=st.slots_len,
                     num_steps=k[0], live_cap=k[1], sampled=k[2],
                     warmup_s=e.warmup_s, capture_s=e.capture_s,
                     k1_per_replay=e.launches["expert_quant_matmul_grouped"])
                for st in compiled.states() for k, e in st.entries.items()]
    states = compiled.states()
    return dict(graphs_captured=compiled.compiles, graphs_kept=len(captured),
                states_kept=[(st.num_slots, st.slots_len) for st in states],
                state_cache_bytes=sum(
                    t.numel() * t.element_size() for st in states
                    for t in (st.caches["layers"].k, st.caches["layers"].v)),
                compile_s_total=compiled.compile_s,
                pool_bytes=compiled.pool_bytes(),
                profiled_request={"eager": {k: eager[k] for k in keep},
                                  "graph": {k: profiled[k] for k in keep}},
                gate=gate, captured=captured)


def _graph_gate(engine) -> dict:
    """The compiled chunk against the eager one at full width: 4 slots
    prefilled with 64-token prompts (one slot dead, one row reaching its
    limit in the second chunk), the same 16-step chunks run by eager
    ``decode_many_batched`` on a copy of the state and by the engine's
    compiled chunk on the state itself, greedy and sampled: tokens,
    Critical/active masks, done and emitted must be equal (the float
    telemetry's largest difference is reported). Three chunks a mode: the
    first captures; the eager chunk and the replay are timed between two
    syncs; the third replay runs under torch.profiler (its device busy
    time and idle share, from the host's clock around it), where the K1
    kernels it ran must number 3 × L × 16."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.model import decode_many_batched, prefill
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = engine.cfg, engine.device
    b, s, steps, chunks, live_cap = 4, 64, 16, 3, 4
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(7))
    slots = s + steps * chunks
    logits, rc, _ = prefill(engine.params, cfg, prompts,
                            qparams=engine.qparams, cache_slots=slots)
    compiled = engine._decode_batched
    fields = ("k", "v", "positions", "length", "offset")
    result = {}
    for sampled in (False, True):
        state = compiled.acquire(b, slots)
        ref = {"layers": dataclasses.replace(rc["layers"], **{
            f: getattr(rc["layers"], f).clone() for f in fields})}
        for f in fields:
            getattr(state.caches["layers"], f).copy_(
                getattr(rc["layers"], f))
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        host = dict(done=np.array([False, False, False, True]),
                    n_emitted=np.ones(b, np.int32),
                    limits=np.array([64, 64, 24, 64], np.int32),
                    eos_tokens=np.full(b, -1, np.int32))
        if sampled:
            host.update(
                rng_keys=np.arange(2 * b, dtype=np.int64).reshape(b, 2) + 9,
                temperatures=np.array([0.7, 0.7, 0.0, 0.7], np.float32),
                top_ks=np.array([0, 20, 0, 0], np.int64))
        rec = dict(eager_ms_per_step=[], graph_ms_per_step=[],
                   float_max_abs_diff=0.0)
        for c in range(chunks):
            kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = decode_many_batched(
                engine.params, cfg, tok.clone(), ref, num_steps=steps,
                done=kw.pop("done"), n_emitted=kw.pop("n_emitted"),
                limits=kw.pop("limits"), eos_tokens=kw.pop("eos_tokens"),
                qparams=engine.qparams, live_cap=live_cap, **kw)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if c < chunks - 1:
                got = compiled(state, tok, num_steps=steps,
                               live_cap=live_cap, **host)
                torch.cuda.synchronize()
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    got = compiled(state, tok, num_steps=steps,
                                   live_cap=live_cap, **host)
                    torch.cuda.synchronize()
                    rec["replay_traced_wall_ms"] = (
                        time.perf_counter() - t1) * 1e3
            t2 = time.perf_counter()
            toks, _, info, dn, emitted = want
            assert torch.equal(got.tokens, toks), \
                f"graph tokens != eager tokens (sampled={sampled}, chunk {c})"
            for f in ("critical_masks", "active_masks"):
                assert torch.equal(getattr(got.info, f), getattr(info, f)), f
            assert torch.equal(got.done, dn) and \
                torch.equal(got.n_emitted, emitted)
            for f in ("gate_mean", "predicted_next"):
                rec["float_max_abs_diff"] = max(
                    rec["float_max_abs_diff"], float(
                        (getattr(got.info, f) - getattr(info, f)).abs().max()))
            rec["eager_ms_per_step"].append((t1 - t0) * 1e3 / steps)
            if c == 0:
                rec["first_call_s"] = t2 - t1     # capture and one replay
            elif c == 1:
                rec["graph_ms_per_step"].append((t2 - t1) * 1e3 / steps)
            tok = got.tokens[-1].clone()
            host.update(done=got.done.cpu().numpy(),
                        n_emitted=got.n_emitted.cpu().numpy())
        assert host["done"][2] and not host["done"][0]
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        k1 = sum(e.count for e in kernels if "grouped_kernel" in e.key)
        assert k1 == 3 * cfg.num_layers * steps, \
            f"the replay ran {k1} K1 kernels, not 3 x L x {steps}"
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        rec.update(
            k1_kernels_per_replay=k1,
            kernels_per_step=sum(e.count for e in kernels) / steps,
            replay_device_busy_ms=busy,
            replay_idle_share=1 - busy / rec["replay_traced_wall_ms"])
        result["sampled" if sampled else "greedy"] = rec
        compiled.release(state)
    return result


def main() -> int:
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py  (takes no arguments; runs "
              "every phase)", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "serving" / "engine.py").is_file():
        print(f"chip_smoke: {src}/repro_torch is missing; run this script "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = _smi()
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all(ptxas_verbose=True)
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    # the tensor-core tiles of K1-K5 are sized to the register file: a
    # toolchain that spills one fails here, not silently in its times
    # (checked where this run built them)
    for name in ("eqm_grouped", "eqm_expert", "qm_dense", "attn_flash_fwd",
                 "attn_key_mass"):
        if name in logs:
            spills = [ln for ln in logs[name].splitlines() if "spill" in ln]
            assert spills and all("0 bytes spill stores, 0 bytes spill loads"
                                  in ln for ln in spills), \
                f"{name} spills: {spills}"

    cfg = get_config("olmoe_1b_7b")
    records = _kernel_cases(cfg, dev)
    t0 = time.perf_counter()
    records.update(_api_cases(cfg, dev))
    launches = _api_phase(cfg, dev)
    print(f"api: phase {time.perf_counter() - t0:.1f}s", flush=True)
    _reference_phase(dev)
    serve_launches, engine = _serve_phase(dev)
    launches.update(serve_launches)
    by_path = {"serve": serve_launches, "session": _session_phase(engine),
               "generate_reference": _reference_full(engine)}

    kernels = []
    for name, (source, replaces, library) in KERNELS.items():
        cases = records[name]
        head = cases[0]
        assert launches[name] > 0, f"{name} never launched"
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            launches_by_path={p: c[name] for p, c in by_path.items()
                              if name in c},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], library=library,
            tc_bound_ms=head["tc_bound_ms"],
            f32_core_bound_ms=head["f32_core_bound_ms"],
            case=head["case"],
            cases=[{k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                      "tc_bound_ms", "f32_core_bound_ms",
                                      "bound_by", "library_ms", "device_ms",
                                      "library_device_ms")}
                   for c in cases]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
