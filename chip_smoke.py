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
     times; then K2 at one expert (the 1-expert lift of the dense and SSM
     projections) at full-width qwen3_0p6b, zamba2_1p2b and
     falcon_mamba_7b shapes, decode M 4 and prefill M 512, both tiers
     held against the plain version, the high tier timed beside bf16
     ``torch.matmul``;
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
     solo ``generate`` equals its batch row (on the card the prefills and
     the decode chunks run as CUDA graph replays); then reduced f32
     qwen3_0p6b (dense), zamba2_1p2b (Mamba2 + shared attention) and
     falcon_mamba_7b (Mamba1): ``generate_batch`` and
     ``generate_reference`` tokens and modeled numbers, card == CPU;
  4. serve — full-width OLMoE-1B-7B ("4/2", random weights from a seeded
     CUDA generator, quantized on the card): a warm run of
     ``generate_batch`` over 8 ragged requests on 4 slots and one
     ``generate`` captures the decode chunk's keys and meets the compiled
     prefill's (its host syncs are reported apart), a second captures the
     prefill's keys (a key is captured at its second call); then the same
     calls again, counted, replaying every prefill and chunk: the launch
     counts of K1 and K2 are read around them and checked. Printed:
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
     launch counters, in the ``graph:`` line. On the same engine, the
     open session (``session:``), ``generate_reference``
     (``reference_full:``), then the prefill graph gate
     (``_prefill_gate``) on a 4-row ragged wave (prompts 512, 400, 256,
     96) and 512-token solo admissions in "4/2" and "4/0" (a second
     engine on the same weights, its experts' 4-bit codes only), and every
     prefill key the engine captured and kept replayed once under
     torch.profiler: its
     K1/K2 kernels by symbol must equal its counted launches;
  4b. window — sliding-window ring caches at the reference's 8,192-token
     window (``window:`` line; ``_window_phase``): reduced f32 windowed
     OLMoE, qwen3_0p6b and zamba2_1p2b card == CPU; on the serve phase's
     weights, full-width OLMoE-1B-7B ("4/2", 4 slots, 16-step chunks):
     the prefill gate on a 9,000-token solo admission, the ring
     decode-chunk gate (replay == eager bitwise under
     ``set_sync_debug_mode("error")``, the ring wrapping mid-chunk), and
     prompts of 9,000, 8,600, 8,160 and 2,000 tokens + 48 through
     ``generate_batch`` (ring positions after every admission; K1 48 a
     decode step, K2 48 a solo admission, exactly); then full-width
     qwen3_0p6b with the window, 2 × (9,000 + 48), K2 84 a step;
  4c. pipeline — the pipelined telemetry replay (``pipeline:`` line;
     ``_pipeline_phase``) on the serve phase's engine: its 8 requests
     inline and pipelined in turns (I P P I, twice), tokens and modeled
     numbers bitwise equal, K1/K2 exact, walls, replay seconds, blocked
     seconds and the replay's overlap with the dispatch thread's device
     work; a ``delay`` fault with one job in flight, a ``replay.chunk``
     raise's invariants, a 2-replica router inline and pipelined; syncs
     by thread (the replay worker makes none);
  4d. dispatch_shards — the data-local MoE dispatch
     (``dispatch_shards:`` line; ``_dispatch_shards_phase``): reduced f32
     OLMoE at D 2 card == CPU; full-width OLMoE-1B-7B at D 4 on the serve
     phase's weights, the prefill graph gate on a 512-token solo
     admission and exactly 48 K2 launches a replay; K2 at the folded
     shape against its plain version (a K2 case);
  5. archs — full-width qwen3_0p6b (28 layers), zamba2_1p2b (38 layers,
     7 shared-attention sites) and falcon_mamba_7b (64 layers), "4/2":
     a 512-token eager prefill on the new engine, then 6 ragged
     requests through ``generate_batch`` on 4 slots, warm (twice) then
     counted (K2 launches exact: 3 dense or 2 SSM a layer per decode step
     and prefill; no K1), and the graph gate on each decode state (KV,
     SSM, SSM + shared KV: eager chunk == replay, every cache leaf
     bitwise), and the prefill graph gate on a 4-row qwen3_0p6b wave
     (prompts 512, 384, 233, 64) and 512-token zamba2_1p2b and
     falcon_mamba_7b solo prefills; one ``arch:`` line a model (wall,
     decode ms/step, peak memory, K2 launches);
  6. frontend — full-width OLMoE-1B-7B through the port's launcher
     (``repro_torch.launch.serve``, the ``frontend:`` line; see
     ``_frontend_phase``). In bf16: (c) ``generate_reference`` through
     the compiled ``decode_many``, graph == eager bitwise, K2 launches
     exact, ms a token eager and replayed, and the static baseline
     against continuous batching. In f32, where a row's tokens do not
     depend on its batch: (a) the open loop over two replicas of one
     engine on driver threads (captures in the threads), every request's
     tokens equal to the same engine's solo ``generate``; (b) ``--mode
     off``, the one-shot and the static batch (dropless capacity), each
     row equal to ``generate_reference``, no packed kernel launched; (d)
     a replica's ``replay.chunk`` fault under driver threads: drained,
     cold-restarted, every handle resolved;
  7. train — the training path (``train:`` line; ``_train_phase``): (a)
     five ``TrainLoop`` steps of the reduced f32 OLMoE-1B-7B on the card
     and on the CPU from the same params and batches, losses within rtol
     1e-4; (b) full-width bf16 train steps (remat "block") of
     OLMoE-1B-7B at 4 of its 16 layers, qwen3_0p6b and zamba2_1p2b (one
     row), 512 tokens a row: step ms, device busy and idle share, kernels
     a step, peak memory, finite losses and grad norms; (c) 60 steps of
     the reduced f32 OLMoE-1B-7B lower the loss by >= 0.3, the final
     checkpoint restores bit for bit, and engines on the restored and on
     the in-memory weights serve 4 requests ("4/2") to the same tokens
     with K1 and K2 launched (``train_skew:``: each layer's expert-load
     skew at init and after training);
  8. expert_parallel — serving over a (1, 4) mesh of ``torch.distributed``
     ranks that share the one card over gloo (``expert_parallel:`` line;
     ``_expert_parallel_phase``): reduced f32 qwen2_moe_a2p7b expert- and
     tensor-parallel, every rank's tokens, replay masks and modeled
     TTFT/TPOT equal to the one-rank CPU run; full-width OLMoE-1B-7B
     ("4/2") through the launcher's ``--full --expert-parallel`` loop in
     f32 (tokens equal to the one-rank run) and bf16 (rows matching
     reported), each rank's routed store exactly 1/4 of the one-rank
     store and its K1/K2 launches equal to the one-rank run's; per rank:
     peak memory, eager ms a decode step, collectives a step and their
     seconds.

The ``prefill_graph:`` line holds the six full-width prefill gates: the
compiled prefill's eager protocol (``graphs=False``) against the
compiled prefill's three calls of one key — an eager first call, then
the capture and its replay, both under ``set_sync_debug_mode("error")``,
then a replay: logits, every ``DyMoEInfo`` leaf and every cache leaf
(the hybrid's shared KV included) bitwise equal; eager and replay ms
(CUDA-synchronized host clock) and device busy ms (torch.profiler), the
memory the eager prefill takes above its baseline and the allocator's
device calls during it, and the K1/K2 kernels a traced replay ran
against the key's counted launches; then each engine's prefill keys,
compile seconds and pool bytes. No serving phase is cut in depth; the
train phase keeps 4 of OLMoE-1B-7B's 16 layers (memory) and one row of
zamba2_1p2b (time), see ``TRAIN_FULL``.

The last lines are the card's name and power limit (nvidia-smi), one JSON
line describing every kernel, and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when there is no CUDA device or when the
repository's sources are not beside this file.
"""
import json
import math
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


# K2 at E = 1 (quant/mixed.py's lift of a dense weight): the FFN and SSM
# projections of the non-MoE paths, (arch, matmul, K, N)
K2_E1_SHAPES = (("qwen3_0p6b", "gate_up", 1024, 3072),
                ("qwen3_0p6b", "down", 3072, 1024),
                ("zamba2_1p2b", "in_proj", 2048, 8384),   # N % 128 == 64
                ("zamba2_1p2b", "out_proj", 4096, 2048),
                ("falcon_mamba_7b", "in_proj", 4096, 16384),
                ("falcon_mamba_7b", "out_proj", 8192, 4096))


def _k2_e1_cases(dev):
    """K2 with one expert at the dense and SSM paths' shapes, "4/2", bf16
    x: decode M 4 (four slots) and prefill M 512. Both tiers are held
    against the plain version; the high tier (4-bit, the heavier) is
    timed, with bf16 ``torch.matmul`` on the dequantized weight as the
    library call."""
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.quant.qtensor import MixedPrecisionWeights
    from repro_torch.quant.quantize import dequantize_tensor

    gen = torch.Generator(device=dev).manual_seed(20)
    plain = km.PLAIN["expert_quant_matmul"]
    records = []
    for arch, name, k, n in K2_E1_SHAPES:
        w = torch.randn((1, k, n), generator=gen, device=dev) * k ** -0.5
        mp = MixedPrecisionWeights.build(w.to(torch.bfloat16), 4, 2, 64)
        del w
        w_hi = dequantize_tensor(mp.high.packed[0], mp.high.scales[0], 4, 64,
                                 torch.bfloat16)
        hi_bytes = mp.high.packed.numel() + mp.high.scales.numel() * 4
        for m in (4, 512):
            x = torch.randn((1, m, k), generator=gen, device=dev
                            ).to(torch.bfloat16)
            kw = dict(hi_bits=4, lo_bits=2, group_size=64)
            err = 0.0
            for tier in (1, 0):
                args = (x, mp.high.packed, mp.high.scales, mp.low.packed,
                        mp.low.scales,
                        torch.full((1,), tier, dtype=torch.int32, device=dev))
                got32 = km.expert_quant_matmul_cuda(
                    *args, out_dtype=torch.float32, **kw)
                ref32 = plain(*args, out_dtype=torch.float32, **kw)
                got = km.expert_quant_matmul_cuda(*args, **kw)
                ref = plain(*args, **kw)
                torch.cuda.synchronize()
                err = max(err, _check(got32, ref32, got, ref))
            args = args[:5] + (torch.ones(1, dtype=torch.int32, device=dev),)
            x2 = x[0]
            records.append(_time_case(
                f"E=1 {arch} {name} 4/2 hi "
                f"{'decode' if m == 4 else 'prefill'} M={m} K={k} N={n}",
                lambda: km.expert_quant_matmul_cuda(*args, **kw),
                lambda: plain(*args, **kw),
                lambda: torch.matmul(x2, w_hi), err,
                hi_bytes + m * k * 2 + m * n * 2, 2.0 * m * k * n))
        del mp, w_hi
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

        # inline replay: which handles a pipelined replay fault takes down
        # depends on timing, so the card == CPU parity runs the serial mode
        s = eng.serve(num_slots=2, slots_len=64, policy="edf",
                      pipeline=False)
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


# the non-MoE families of the arch phases: dense, hybrid (Mamba2 + shared
# attention), Mamba1
ARCHS = ("qwen3_0p6b", "zamba2_1p2b", "falcon_mamba_7b")


def _reference_archs(dev):
    """The dense, hybrid and Mamba1 families on the card against the plain
    path on the CPU, reduced and f32: ``generate_batch`` (4 ragged
    requests, 2 slots) and ``generate_reference`` tokens, and every
    modeled number (without experts: the cost model alone), equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, Request

    modeled = ("ttft_s", "tpot_s", "cache_stats", "prefill_weight_bytes",
               "decode_weight_bytes_per_tok")
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(2)
        reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, int(s))], max_new_tokens=int(m))
            for s, m in ((9, 6), (17, 11), (5, 8), (12, 20))]
        cpu_eng = DyMoEEngine(cfg, params, device="cpu")
        gpu_eng = DyMoEEngine(cfg, params, device=dev)
        for name, run in (
                ("generate_batch", lambda e: e.generate_batch(reqs,
                                                              num_slots=2)),
                ("generate_reference",
                 lambda e: [e.generate_reference(reqs[1])])):
            cpu, gpu = run(cpu_eng), run(gpu_eng)
            ct, gt = [r.tokens for r in cpu], [r.tokens for r in gpu]
            assert gt == ct, f"{arch} {name}: card {gt} != CPU {ct}"
            for i, (c, g) in enumerate(zip(cpu, gpu)):
                for f in modeled:
                    assert getattr(g, f) == getattr(c, f), \
                        f"{arch} {name} request {i} {f}: card " \
                        f"{getattr(g, f)} != CPU {getattr(c, f)}"
        print(f"reference: reduced {arch} f32 4/2, generate_batch "
              f"({len(reqs)} requests, 2 slots) and generate_reference: "
              f"card tokens and modeled ttft/tpot == CPU "
              f"({sum(map(len, ct))} tokens)", flush=True)


# ------------------------------------------------------------------ serve


def _serve_requests(cfg) -> list:
    """The serve phase's 8 requests: prompts of 64-512 tokens, 16-48 new
    tokens, from a seeded numpy generator."""
    import numpy as np
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    return [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, int(rng.integers(64, 513)))],
        max_new_tokens=int(rng.integers(16, 49))) for _ in range(8)]


def _serve_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig

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
    reqs = _serve_requests(cfg)
    solo_req = reqs[3]

    torch.cuda.reset_peak_memory_stats()
    # the warm (cold-start) run: the compiled chunk captures the keys the
    # counted runs below meet, the compiled prefill meets its keys; its
    # host syncs (the captures') apart
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
    # the second warm run: the compiled prefill captures its keys (at a
    # key's second call)
    t0 = time.perf_counter()
    warm2 = engine.generate_batch(reqs, num_slots=4)
    torch.cuda.synchronize()
    warm2_wall = time.perf_counter() - t0
    warm2_stats = dict(engine.last_stats)
    engine.generate(solo_req)
    torch.cuda.synchronize()
    warm2_solo_stats = dict(engine.last_stats)
    assert [r.tokens for r in warm2] == [r.tokens for r in warm]

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
    assert all(st[k] == 0 for st in (batch_stats, solo_stats)
               for k in ("compiles", "prefill_compiles")), \
        "the counted runs met a key the warm run did not capture"
    sampling = _sampled_batch(engine, reqs[:4])
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    profiled = _profile_decode(engine, activities)
    graph = _graph_phase(engine, activities, profiled)
    replay_counts += _replay_counts(engine._decode_batched, checked)
    graph.update(serve_wall_cold_s=cold_wall,
                 serve_wall_second_s=warm2_wall, serve_wall_warm_s=batch_wall,
                 cold_batch=dict(compiles=cold_stats["compiles"],
                                 compile_s=cold_stats["compile_s"]),
                 cold_solo=dict(compiles=cold_solo_stats["compiles"],
                                compile_s=cold_solo_stats["compile_s"]),
                 prefill_captures=[dict(compiles=st["prefill_compiles"],
                                        compile_s=st["prefill_compile_s"])
                                   for st in (cold_stats, cold_solo_stats,
                                              warm2_stats,
                                              warm2_solo_stats)],
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


def _thread_syncs(records) -> dict:
    """``(thread, file:line) -> count`` of the host syncs that
    ``torch.cuda.set_sync_debug_mode("warn")`` reported, from the
    ``(thread name, file, line, message)`` records of ``_sync_recorder``
    (not its one-time notice that the mode is a prototype)."""
    return dict(Counter(f"{t} {Path(f).name}:{n}" for t, f, n, m in records
                        if "synchroniz" in m and "prototype" not in m))


def _sync_recorder(records):
    """A ``warnings.showwarning`` that keeps the thread a warning came
    from: the worker's syncs, if any, are told from the dispatch
    thread's."""
    import threading

    def show(message, category, filename, lineno, file=None, line=None):
        records.append((threading.current_thread().name, filename, lineno,
                        str(message)))
    return show


def _pipeline_phase(engine) -> dict:
    """The pipelined telemetry replay (``pipeline=True``, a ``ReplayStream``
    worker) on the serve phase's full-width OLMoE-1B-7B, its graph keys
    met again by two uncounted warm runs: the serve phase's 8 requests on
    4 slots, inline (I) and pipelined (P) in turns, I P P I twice, each on
    a fresh session.
    Tokens and modeled TTFT/TPOT (and cache stats, weight bytes) must be
    equal bitwise across all 8 runs, and each run's K1/K2 launches exact
    (3 x L x (decode steps + batched waves) and 3 x L x solo waves). Per
    run: the wall, the jobs' own replay seconds, the dispatch thread's
    seconds blocked in a pipelined submit, and how many of the replay
    seconds fall inside the dispatch thread's device work (its chunks and
    admission waves, launch through the boundary fetch: the waits a worker
    can use). Then a ``delay`` of 250 ms (longer than a chunk) on every
    chunk replay with ``max_inflight_chunks=1`` (numbers unchanged, the
    blocked seconds shown), a ``replay.chunk`` raise on the first chunk of 4 requests in
    flight (all 4 resolve with ``ReplayError``, one replay fault, status
    "degraded", inline from then on; 2 requests served after the recovery
    equal a fresh inline session's, tokens and modeled numbers from a cold
    orchestrator), and a 2-replica ``ClusterRouter`` inline and pipelined
    (placements, tokens and modeled numbers equal). All of it under
    ``set_sync_debug_mode("warn")``, syncs counted by thread and source
    line: the worker ("dymoe-replay") must make none. Prints the
    ``pipeline:`` line."""
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.serving import ClusterRouter, \
        ContinuousBatchingScheduler, FaultInjector, FaultSpec, ReplayError, \
        SchedulerConfig

    cfg, L = engine.cfg, engine.cfg.num_layers
    reqs = _serve_requests(cfg)
    t_phase = time.perf_counter()

    def key(out):
        return [(r.tokens, r.ttft_s, r.tpot_s, r.cache_stats,
                 r.prefill_weight_bytes, r.decode_weight_bytes_per_tok)
                for r in out]

    def serve(pipeline, scfg=SchedulerConfig(), faults=None, warm=False):
        s = ContinuousBatchingScheduler(engine, num_slots=4, scfg=scfg,
                                        faults=faults)
        work, jobs = [], []

        def spans(fn, into):
            def timed(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    into.append((t0, time.perf_counter()))
            return timed

        s._run_chunk = spans(s._run_chunk, work)
        s._admit_wave = spans(s._admit_wave, work)
        s._run_replay = spans(s._run_replay, jobs)
        km.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.run(reqs, pipeline=pipeline)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = dict(s.stats)
        k1 = km.LAUNCHES["expert_quant_matmul_grouped"]
        k2 = km.LAUNCHES["expert_quant_matmul"]
        if warm:
            return out, st
        assert k1 == 3 * L * (st["decode_steps"] + st["waves_batched"]), \
            (k1, st)
        assert k2 == 3 * L * st["waves_solo"], (k2, st)
        assert st["compiles"] == st["prefill_compiles"] == 0, st
        replay_spans = sum(b - a for a, b in jobs)
        overlap = sum(max(0.0, min(b1, b2) - max(a1, a2))
                      for a1, b1 in jobs for a2, b2 in work)
        return out, dict(
            mode="P" if pipeline else "I", wall_s=wall,
            replay_s=st["replay_s"], replay_blocked_s=st["replay_blocked_s"],
            replay_jobs=st["replay_jobs"], replay_span_s=replay_spans,
            device_work_s=sum(b - a for a, b in work),
            replay_in_device_work_s=overlap,
            replay_in_device_work_share=overlap / max(replay_spans, 1e-12),
            launches=dict(km.LAUNCHES))

    records = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = _sync_recorder(records)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            # the phases since the serve phase may have dropped its keys:
            # one run meets them again (a prefill key captures at its
            # second call), uncounted
            for _ in range(2):
                want = key(serve(False, warm=True)[0])
            runs = []
            for pipeline in (False, True, True, False) * 2:
                out, rec = serve(pipeline)
                assert key(out) == want, \
                    f"{rec['mode']} run {len(runs)}: tokens or modeled " \
                    "numbers differ from the warm inline run's"
                runs.append(rec)
            syncs_ab = _thread_syncs(records)
            # ---- delay: a slow replay, one job in the queue
            delay = FaultInjector([FaultSpec(site="replay.chunk",
                                             kind="delay", delay_s=0.25,
                                             times=10 ** 6)])
            out, slow = serve(True, SchedulerConfig(max_inflight_chunks=1),
                              delay)
            assert key(out) == want, "delay fault changed a number"
            slow["delays"] = len(delay.fired)
            # ---- raise on the first chunk's replay, 4 requests in flight
            faults = FaultInjector([FaultSpec(site="replay.chunk", at=0)])
            s = ContinuousBatchingScheduler(engine, num_slots=4,
                                            faults=faults)
            s._ensure_started(slots_len=1024, pipeline=True)
            first = [s.submit(r) for r in reqs[:4]]
            while s.step():
                pass
            s.flush()
            second = [s.submit(r) for r in reqs[4:6]]
            while s.step():
                pass
            s.flush()
            hl = s.health()
            inline_after = not s._stream.pipelined
            s.close()
            clean = ContinuousBatchingScheduler(engine, num_slots=4)
            clean._ensure_started(slots_len=1024, pipeline=False)
            fresh = [clean.submit(r) for r in reqs[4:6]]
            while clean.step():
                pass
            clean.close()
            assert all(h.done for h in first + second)
            assert all(isinstance(h.error, ReplayError) for h in first), \
                [type(h.error).__name__ for h in first]
            assert hl.replay_faults == 1 and hl.status == "degraded", hl
            assert inline_after
            assert key([h.result(drive=False) for h in second]) == \
                key([h.result(drive=False) for h in fresh]), \
                "after recovery != a fresh session"
            # ---- two replicas over the engine, sync mode
            routed = {}
            for pipeline in (False, True):
                with ClusterRouter.replicate(
                        engine, 2, num_slots=2, slots_len=1024,
                        pipeline=pipeline) as router:
                    hs = [router.submit(r) for r in reqs]
                    res = [h.result() for h in hs]
                    routed[pipeline] = ([h.replica for h in hs], key(res))
            assert routed[True] == routed[False], "pipelined router != inline"
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = _thread_syncs(records)
    worker = {k: v for k, v in syncs.items() if k.startswith("dymoe-replay")}
    assert not worker, f"the replay worker synchronized: {worker}"

    def med(mode, field):
        xs = sorted(r[field] for r in runs if r["mode"] == mode)
        return (xs[1] + xs[2]) / 2

    summary = dict(
        runs=runs,
        wall_median_s={m: med(m, "wall_s") for m in "IP"},
        pipelined_over_inline_wall=med("P", "wall_s") / med("I", "wall_s"),
        replay_median_s={m: med(m, "replay_s") for m in "IP"},
        replay_in_device_work_share_p=med("P", "replay_in_device_work_share"),
        tokens_and_modeled_equal=True, syncs_by_thread_ab=syncs_ab,
        worker_syncs=0, delay=slow,
        fault=dict(first=[type(h.error).__name__ for h in first],
                   replay_faults=hl.replay_faults, status=hl.status,
                   inline_after=inline_after,
                   after_recovery_equals_fresh=True),
        router=dict(placements=routed[True][0], equal=True),
        phase_s=time.perf_counter() - t_phase)
    print("pipeline: " + json.dumps(summary), flush=True)
    return runs[1]["launches"]


def _dispatch_shards_phase(dev, engine) -> tuple:
    """The data-local MoE dispatch (``moe_dispatch_shards``): (a) reduced
    f32 OLMoE with D = 2, the card against the CPU: ``generate_batch`` on
    one slot (every admission a solo prefill of two token groups) and
    ``generate_reference``, tokens and modeled numbers equal, K2 exact;
    (b) full-width OLMoE-1B-7B "4/2" with D = 4 on the serve phase's
    params and packed store: the prefill graph gate on a 512-token solo
    admission (eager == capture == replay bitwise), then one replay
    counted: exactly 48 K2 launches (three a layer: the 4 groups' capacity
    buffers folded into one) and no K1; (c) K2 at that folded shape (64
    experts, M = 4 x ``_capacity(cfg, 128)`` rows of a real dispatch of
    layer 0) against its plain version, timed as a K2 case. Prints the
    ``dispatch_shards:`` line; returns ({path: launches}, the K2 case)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.models.model import _index_tree, init_params
    from repro_torch.quant.quantize import dequantize_tensor
    from repro_torch.serving import DyMoEEngine, EngineConfig, Request

    t_phase = time.perf_counter()
    # ---- (a) reduced f32, D = 2: card == CPU
    base = dataclasses.replace(get_config("olmoe_1b_7b").reduced(),
                               moe_dispatch_shards=2)
    params = init_params(base, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(5)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, base.vocab_size, s)], max_new_tokens=m)
        for s, m in ((10, 6), (18, 9), (6, 5), (14, 7))]

    def key(out):
        return [(r.tokens, r.ttft_s, r.tpot_s, r.cache_stats,
                 r.prefill_weight_bytes, r.decode_weight_bytes_per_tok)
                for r in out]

    cpu = DyMoEEngine(base, params, device="cpu")
    gpu = DyMoEEngine(base, params, device=dev)
    want = key(cpu.generate_batch(reqs, num_slots=1))
    km.reset_launch_counts()
    got = key(gpu.generate_batch(reqs, num_slots=1))
    reduced_launches = dict(km.LAUNCHES)
    st = gpu.last_stats
    assert got == want, "reduced D=2: card != CPU"
    assert st["waves_solo"] == len(reqs) and reduced_launches[
        "expert_quant_matmul"] == 3 * base.num_layers * len(reqs), \
        (reduced_launches, st)
    assert key([gpu.generate_reference(reqs[1])]) == \
        key([cpu.generate_reference(reqs[1])]), \
        "reduced D=2 generate_reference: card != CPU"
    del cpu, gpu

    # ---- (b) full width, D = 4, on the serve phase's weights
    cfg4 = dataclasses.replace(engine.cfg, moe_dispatch_shards=4)
    L = cfg4.num_layers
    eng4 = DyMoEEngine(cfg4, engine.params, EngineConfig(decode_chunk=16),
                       device=dev, qparams=engine.qparams)
    solo = np.random.default_rng(11).integers(1, cfg4.vocab_size, (1, 512))
    gate = _prefill_gate(eng4, "olmoe_1b_7b solo 4/2 D=4", solo, {}, 1024)
    assert gate["launch_error"] is None, gate["launch_error"]
    km.reset_launch_counts()                 # the path starts here
    eng4._prefill(solo, cache_slots=1024)
    torch.cuda.synchronize()
    launches = dict(km.LAUNCHES)             # ... and ends here
    assert launches == {"expert_quant_matmul": 3 * L,
                        "expert_quant_matmul_grouped": 0}, launches
    assert gate["launches_per_replay"] == {"expert_quant_matmul": 3 * L}, \
        gate["launches_per_replay"]
    del eng4

    # ---- (c) K2 at the folded shape, on a real dispatch of layer 0
    lp = _index_tree(engine.params["layers"], 0)["moe"]
    qw = {n: q.index(0) for n, q in engine.qparams["layers"]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn((512, cfg4.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16)
    t = 512 // 4
    buf = torch.cat([tmoe._dispatch(lp, cfg4, x[i * t:(i + 1) * t], None).buf
                     for i in range(4)], dim=1)        # (E, 4 C_d, dm)
    e, m, k = buf.shape
    assert m == 4 * tmoe._capacity(cfg4, t), buf.shape
    mp = qw["w_gate"]
    crit_h = (np.random.default_rng(31).random(e) < 0.5).astype(np.int32)
    crit = torch.from_numpy(crit_h).to(dev)
    gs = cfg4.dymoe.group_size
    args = (buf, mp.high.packed, mp.high.scales, mp.low.packed, mp.low.scales,
            crit)
    kw = dict(hi_bits=mp.high.bits, lo_bits=mp.low.bits, group_size=gs)
    plain = km.PLAIN["expert_quant_matmul"]
    got32 = km.expert_quant_matmul_cuda(*args, out_dtype=torch.float32, **kw)
    ref32 = plain(*args, out_dtype=torch.float32, **kw)
    got_ = km.expert_quant_matmul_cuda(*args, **kw)
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    err = _check(got32, ref32, got_, ref)
    n = mp.high.packed.shape[1]
    w_sel = torch.where(
        crit.bool()[:, None, None],
        dequantize_tensor(mp.high.packed, mp.high.scales, mp.high.bits, gs,
                          torch.bfloat16),
        dequantize_tensor(mp.low.packed, mp.low.scales, mp.low.bits, gs,
                          torch.bfloat16))
    n_hi = int(crit_h.sum())

    def qbytes(q, experts):
        return experts * (q.packed[0].numel() + q.scales[0].numel() * 4)

    nbytes = (qbytes(mp.high, n_hi) + qbytes(mp.low, e - n_hi)
              + e * m * k * 2 + e * m * n * 2)
    case = _time_case(f"gate_up 4/2 folded D=4 M={m}",
                      lambda: km.expert_quant_matmul_cuda(*args, **kw),
                      lambda: plain(*args, **kw),
                      lambda: torch.bmm(buf, w_sel), err, nbytes,
                      2.0 * e * m * k * n)
    del w_sel
    print("dispatch_shards: " + json.dumps(dict(
        reduced=dict(shards=2, requests=len(reqs), card_equals_cpu=True,
                     launches=reduced_launches),
        full=dict(shards=4, gate=gate, launches=launches),
        k2_folded=dict(case=case["case"], max_abs_err=err, ms=case["ms"],
                       plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                       library_ms=case["library_ms"]),
        phase_s=time.perf_counter() - t_phase)), flush=True)
    return {"dispatch_shards_reduced": reduced_launches,
            "dispatch_shards": launches}, case


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
        pbefore = set(engine._prefill.entries())
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
        pnew = [k for k in engine._prefill.entries() if k not in pbefore]
        return dict(handles=hs, wall=wall, walls=walls, health=health,
                    prefill_keys=pnew,
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
            prefill_keys_new=[list(k[:3]) for k in r["prefill_keys"]],
            prefill_captures=st["prefill_compiles"],
            prefill_compile_s=st["prefill_compile_s"],
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
    eager), after one warm call (its prefill key's first, eager call; the
    counted call captures the key and replays it, with the same counts).
    Its K2 launches must be 3 x L a prefill
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
            ran, traces, _ = _traced_counts(
                lambda: compiled(st, tok, num_steps=steps, live_cap=cap,
                                 **host), entry.launches, ident)
            checked.add(ident)
            rows.append(dict(slots=b, slots_len=st.slots_len, num_steps=steps,
                             live_cap=cap, sampled=sampled, kernels=ran,
                             traces=traces))
    return rows


def _traced_counts(replay, launches: dict, ident):
    """``replay()`` under torch.profiler: the port's kernels it ran, by
    symbol (``SYMBOLS``), must equal ``launches`` (a key's counted
    launches a replay). A trace that shows fewer is taken again, up to
    three times; one that shows more fails at once. Returns the counts,
    the traces taken and the last trace's CUDA kernel events."""
    assert set(launches) == set(SYMBOLS), launches
    traces = []
    while len(traces) < 3:
        kernels = _trace(replay)
        ran = {name: sum(e.count for e in kernels if sym in e.key)
               for name, sym in SYMBOLS.items()}
        traces.append(ran)
        assert all(ran[k] <= launches[k] for k in ran), \
            f"key {ident}: the replay ran {ran}, counted {launches}"
        if ran == launches:
            break
    assert ran == launches, \
        f"key {ident}: the replays ran {traces}, counted {launches}"
    return ran, len(traces), kernels


# tiny f64 kernels launched around a traced call (the model runs no f64
# op, so their events are told apart by the "double" in their names)
TRACE_PADS = 1024


def _trace(fn) -> list:
    """``fn()`` under torch.profiler: its CUDA kernel events. ``TRACE_PADS``
    tiny kernels run before and after it inside the trace and are left
    out of the result: late in this long process the profiler lost the
    same records of every trace of a large call (31 of a falcon_mamba_7b
    512-token prefill's 21,071 kernels, one of them a K2 launch, where a
    fresh process lost none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PADS):
            pad.add_(1.0)
        fn()
        for _ in range(TRACE_PADS):
            pad.add_(1.0)
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "double" not in e.key]


def _prefill_engine(model, compiled, **extra) -> dict:
    """A compiled prefill's bookkeeping: keys captured, their seconds, the
    pool's bytes, and the kept keys, least recently used first (shape,
    cache slots, row-local, whether captured, capture seconds, K1/K2 a
    replay)."""
    return dict(model=model, compiles=compiled.compiles,
                compile_s=compiled.compile_s,
                pool_bytes=compiled.pool_bytes(), keys=[
                    dict(batch=k[0], seq=k[1], cache_slots=k[2],
                         row_local=k[3], captured=e.graph is not None,
                         capture_s=e.capture_s,
                         launches={n: c for n, c in e.launches.items()
                                   if c})
                    for k, e in compiled.entries().items()], **extra)


def _prefill_replay_counts(compiled) -> list:
    """Every key the compiled prefill captured and kept, its graph
    replayed once under torch.profiler on its static inputs
    (``_traced_counts``)."""
    return [dict(key=list(k[:4]), kernels=_traced_counts(
        e.graph.replay, e.launches, k)[0])
        for k, e in compiled.entries().items() if e.graph is not None]


def _prefill_gate(engine, label, prompt, kw, cache_slots) -> dict:
    """One full-width prefill (``prompt`` a host (B, S) array, ``kw`` its
    host ``lengths`` / ``row_capacities`` and ``row_local``), the compiled
    prefill's eager protocol (``CompiledPrefill(engine, graphs=False)``)
    against the engine's compiled prefill on the same inputs, three calls
    each. The eager protocol's first call warms up; its second is a plain
    eager prefill (timed, with the memory it takes above its baseline and
    the allocator's device allocations and frees during it); its third
    runs into its fixed outputs (timed). The compiled prefill's first call
    (eager) and second (capture and replay) run under
    ``set_sync_debug_mode("error")``, its third is a timed replay: logits,
    every ``DyMoEInfo`` leaf and every cache leaf bitwise equal to the
    eager protocol's after each. Then one eager call and one replay under
    torch.profiler: their device busy ms (an eager trace of ~10^5 kernels
    may drop a record, so only the replay's kernels are counted); the
    replay's K1/K2 kernels must equal the key's counted launches
    (``_traced_counts``): a mismatch is kept as ``launch_error`` and fails
    the run once the ``prefill_graph:`` line is printed."""
    import torch
    from repro_torch.serving.compiled import CompiledPrefill

    cp, plain = engine._prefill, CompiledPrefill(engine, graphs=False)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def eager():
        return plain(prompt, cache_slots=cache_slots, **kw)

    def graph():
        return cp(prompt, cache_slots=cache_slots, **kw)

    def same(got, want, when):
        assert len(got) == len(want), (label, when)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), \
                f"{label}: graph != eager ({when}, output {i})"

    def allocator():
        st = torch.cuda.memory_stats()
        return [st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")]

    eager()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a0 = allocator()
    _, eager_ms = timed(eager)
    device_calls = [b - a for a, b in zip(a0, allocator())]
    extra = (torch.cuda.max_memory_allocated() - base) / 2**30
    want, fixed_ms = timed(eager)
    want = want.tensors()
    n0 = cp.compiles
    call_ms = []
    for call in ("first call", "second call"):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, ms = timed(graph)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        same(out.tensors(), want, call)
        call_ms.append(ms)
    out, graph_ms = timed(graph)
    same(out.tensors(), want, "replay")
    key = next(reversed(cp.entries()))
    entry = cp.entries()[key]
    eager_kernels = _trace(eager)
    try:
        ran, traces, kernels = _traced_counts(graph, entry.launches,
                                              (label, "replay"))
        launch_error = None
    except AssertionError as err:
        kernels, traces, launch_error = _trace(graph), 3, str(err)
        ran = {name: sum(k.count for k in kernels if sym in k.key)
               for name, sym in SYMBOLS.items()}

    def busy(ks):
        return sum(e.self_device_time_total for e in ks) / 1e3

    return dict(
        case=label, batch=prompt.shape[0], seq=prompt.shape[1],
        lengths=[int(x) for x in kw.get("lengths", [prompt.shape[1]])],
        cache_slots=cache_slots, captures=cp.compiles - n0,
        outputs_bitwise_equal=len(want), eager_ms=eager_ms,
        eager_fixed_outputs_ms=fixed_ms,
        eager_device_alloc_free_retries=device_calls,
        first_call_ms=call_ms[0], capture_call_ms=call_ms[1],
        graph_ms=graph_ms,
        eager_device_busy_ms=busy(eager_kernels),
        graph_device_busy_ms=busy(kernels),
        graph_idle_share=1 - busy(kernels) / graph_ms,
        eager_kernels=sum(e.count for e in eager_kernels),
        graph_kernels=sum(e.count for e in kernels),
        launches_per_replay={k: v for k, v in ran.items() if v},
        traces=traces, launch_error=launch_error,
        capture_s=entry.capture_s, eager_extra_gib=extra)


def _prefill_olmoe(engine) -> dict:
    """The prefill graph gate on the serve phase's full-width OLMoE-1B-7B:
    a 4-row ragged row-local wave (K1) and a 512-token solo admission (K2)
    in "4/2", and the solo admission again in "4/0" on a second engine
    over the same weights and the same 4-bit expert codes; then every
    prefill key the serve engine kept replayed under torch.profiler."""
    import dataclasses

    import numpy as np
    from repro_torch.models.layers.moe import _capacity
    from repro_torch.quant.qtensor import MixedPrecisionWeights
    from repro_torch.serving import DyMoEEngine, EngineConfig

    cfg = engine.cfg
    rng = np.random.default_rng(11)
    lens = np.array([512, 400, 256, 96], np.int32)
    wave = np.zeros((4, 512), np.int64)
    for i, s in enumerate(lens):
        wave[i, 512 - s:] = rng.integers(1, cfg.vocab_size, s)
    solo = rng.integers(1, cfg.vocab_size, (1, 512))
    gates = [_prefill_gate(engine, "olmoe_1b_7b wave 4/2", wave, dict(
        lengths=lens, row_local=True, row_capacities=np.array(
            [_capacity(cfg, int(s)) for s in lens], np.int64)), 1024),
        _prefill_gate(engine, "olmoe_1b_7b solo 4/2", solo, {}, 1024)]
    q40 = {"layers": {"moe": {
        name: MixedPrecisionWeights(high=mp.high, low=None)
        for name, mp in engine.qparams["layers"]["moe"].items()}}}
    cfg40 = dataclasses.replace(cfg, dymoe=dataclasses.replace(
        cfg.dymoe, low_bits=0))
    eng40 = DyMoEEngine(cfg40, engine.params, EngineConfig(decode_chunk=16),
                        device=engine.device, qparams=q40)
    gates.append(_prefill_gate(eng40, "olmoe_1b_7b solo 4/0", solo, {}, 1024))
    cp = engine._prefill
    return dict(gates=gates, engine=_prefill_engine(
        "olmoe_1b_7b", cp, replay_counts=_prefill_replay_counts(cp),
        pool_bytes_4_0=eng40._prefill.pool_bytes()))


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
    warm = []      # capture both modes' keys first (one prefill key)
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
        assert engine.last_stats["prefill_compiles"] == 0, engine.last_stats
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


def _serve_archs(dev) -> dict:
    """Full-width ``qwen3_0p6b`` (28 layers), ``zamba2_1p2b`` (38 layers,
    7 shared-attention sites) and ``falcon_mamba_7b`` (64 layers, d_inner
    8192), "4/2", random weights from a seeded CUDA generator, quantized
    on the card: a 512-token eager prefill timed on the new engine
    (``_fresh_prefill_ms``), then 6 ragged requests through
    ``generate_batch`` on 4 slots (a warm run captures the chunk keys and
    meets the prefill keys, a second captures the prefill keys), then the
    same again, counted:
    K2 launches must be (3 dense, 2 SSM) x L x (decode steps + prefills),
    K1 none. Then the graph gate on each model's decode state
    (``_arch_gate``) and the prefill graph gate (``_prefill_gate``: a
    4-row wave on the dense model, a 512-token solo prefill on the SSM
    ones). Prints one ``arch:`` line a model (wall, decode ms/step, peak
    memory, K2 launches) and returns K2's launches by path, ``dense`` and
    ``ssm`` (hybrid and Mamba1 together), and the prefill gates with each
    engine's prefill keys."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig, Request

    by_path = {"dense": Counter(), "ssm": Counter()}
    gates = dict(gates=[], engines=[])
    for arch in ARCHS:
        cfg = get_config(arch)
        kind = cfg.block_kinds()[0]
        L = cfg.num_layers
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
        engine = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=16),
                             device=dev)
        del params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        fresh = _fresh_prefill_ms(engine)
        rng = np.random.default_rng(3)
        reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, int(rng.integers(64, 513)))],
            max_new_tokens=int(rng.integers(16, 41))) for _ in range(6)]
        t0 = time.perf_counter()
        warm = engine.generate_batch(reqs, num_slots=4)
        torch.cuda.synchronize()
        cold_wall = time.perf_counter() - t0
        cold = dict(engine.last_stats)
        t0 = time.perf_counter()               # captures the prefill keys
        second = engine.generate_batch(reqs, num_slots=4)
        torch.cuda.synchronize()
        second_wall = time.perf_counter() - t0
        second_stats = dict(engine.last_stats)
        assert [r.tokens for r in second] == [r.tokens for r in warm]
        km.reset_launch_counts()               # this path starts here
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            out = engine.generate_batch(reqs, num_slots=4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode("default")
        launches = dict(km.LAUNCHES)           # this path ends here
        stats = dict(engine.last_stats)
        assert [r.tokens for r in out] == [r.tokens for r in warm]
        assert stats["compiles"] == 0 == stats["prefill_compiles"], stats
        q = engine.qparams["layers"]     # K2 per layer: one a packed matrix
        per_layer = len(q["mlp"] if "mlp" in q else q["ssm"])
        prefills = stats["waves_batched"] + stats["waves_solo"]
        expect = per_layer * L * (stats["decode_steps"] + prefills)
        k2 = launches["expert_quant_matmul"]
        assert k2 == expect > 0, (arch, launches, stats)
        assert launches["expert_quant_matmul_grouped"] == 0, launches
        if kind == "ssm":          # one exact-shape solo prefill a request
            assert stats["waves_batched"] == 0, stats
        for r, q in zip(out, reqs):
            assert len(r.tokens) == q.max_new_tokens
            assert all(0 <= v < cfg.vocab_size for v in r.tokens)
            assert np.isfinite(r.ttft_s) and r.ttft_s > 0
            assert np.isfinite(r.tpot_s) and r.tpot_s > 0
            assert r.cache_stats is None and r.decode_timings is None
        n_tok = sum(len(r.tokens) for r in out)
        gate = _arch_gate(engine)
        gates["gates"].append(_arch_prefill_gate(engine))
        gates["engines"].append(_prefill_engine(arch, engine._prefill))
        summary = dict(
            arch=arch, layers=L, d_model=cfg.d_model,
            d_ff=cfg.d_ff or None, d_inner=cfg.d_inner or None,
            init_quantize_s=init_s, prompt_tokens=[q.prompt_len
                                                   for q in reqs],
            new_tokens=[len(r.tokens) for r in out],
            prefill512_fresh_ms=fresh, serve_wall_cold_s=cold_wall,
            cold=dict(compiles=cold["compiles"], compile_s=cold["compile_s"]),
            serve_wall_second_s=second_wall, second=dict(
                prefill_compiles=second_stats["prefill_compiles"],
                prefill_compile_s=second_stats["prefill_compile_s"]),
            serve_wall_s=wall, decode_tok_per_s=(n_tok - len(reqs)) / wall,
            batch=stats, host_syncs=_sync_sites(syncs),
            k2_launches=k2, k2_per_decode_step=per_layer * L,
            modeled_edge_ttft_s=[r.ttft_s for r in out],
            modeled_edge_tpot_s=[r.tpot_s for r in out], gate=gate,
            max_memory_allocated_gib=torch.cuda.max_memory_allocated()
            / 2**30)
        print("arch: " + json.dumps(summary), flush=True)
        by_path["dense" if kind == "attn_dense" else "ssm"].update(launches)
        del engine, warm, out
    return {p: dict(c) for p, c in by_path.items()}, gates


def _fresh_prefill_ms(engine) -> list:
    """A 512-token solo ``prefill`` (cache slots 512) on a model's new
    engine, before it serves anything: two calls, each one's ms
    (CUDA-synchronized host clock). The same call as the prefill gate's
    eager one, made here so that one run holds both readings: early in
    the model's phase, and late, after its serve runs, captures and
    traces."""
    import torch
    from repro_torch.models.model import prefill

    cfg = engine.cfg
    gen = torch.Generator(device=engine.device).manual_seed(7)
    prompt = torch.randint(1, cfg.vocab_size, (1, 512),
                           device=engine.device, generator=gen)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(engine.params, cfg, prompt, qparams=engine.qparams,
                cache_slots=512)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def _arch_prefill_gate(engine) -> dict:
    """``_prefill_gate`` on a non-MoE model: a 4-row ragged wave (prompts
    512, 384, 233, 64) on a dense model, a 512-token solo prefill on an
    SSM or hybrid one (they admit solo)."""
    import numpy as np

    cfg = engine.cfg
    rng = np.random.default_rng(12)
    if cfg.block_kinds()[0] == "ssm":
        return _prefill_gate(engine, f"{cfg.name} solo", rng.integers(
            1, cfg.vocab_size, (1, 512)), {}, 512)
    lens = np.array([512, 384, 233, 64], np.int32)
    wave = np.zeros((4, 512), np.int64)
    for i, s in enumerate(lens):
        wave[i, 512 - s:] = rng.integers(1, cfg.vocab_size, s)
    return _prefill_gate(engine, f"{cfg.name} wave", wave,
                         dict(lengths=lens, row_local=True), 512)


def _arch_gate(engine) -> dict:
    """The compiled chunk against the eager one on a full-width non-MoE
    decode state (KV caches; SSM state; the hybrid's SSM state and shared
    KV stack): 4 rows prefilled with 64-token prompts (one dead, one
    reaching its limit in the second chunk); three 16-step greedy chunks
    run by eager ``decode_many_batched`` on a copy of the state and by the
    engine's compiled chunk on the state itself (the first captures, the
    third replays under torch.profiler). Tokens, done, emitted and every
    cache leaf must be bitwise equal. Returns the eager and replay ms per
    step of the second chunk; the third's device busy time, K2 kernels and
    their device time, and the idle share of a replay."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.kv_cache import cache_tensors
    from repro_torch.models.model import decode_many_batched, prefill
    from torch.profiler import ProfilerActivity, profile

    cfg, dev = engine.cfg, engine.device
    gen = torch.Generator(device=dev).manual_seed(7)
    rec = {}
    b, s, steps, chunks = 4, 64, 16, 3
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=gen)
    slots = s + chunks * steps
    logits, rc, _ = prefill(engine.params, cfg, prompts,
                            qparams=engine.qparams, cache_slots=slots)
    compiled = engine._decode_batched
    state = compiled.acquire(b, slots)
    ref = {}
    for part, c in rc.items():
        ref[part] = dataclasses.replace(
            c, **{f: t.clone() for f, t in cache_tensors(c)})
        for f, t in cache_tensors(c):
            getattr(state.caches[part], f).copy_(t)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    host = dict(done=np.array([False, False, False, True]),
                n_emitted=np.ones(b, np.int32),
                limits=np.array([64, 64, 24, 64], np.int32),
                eos_tokens=np.full(b, -1, np.int32))
    for c in range(chunks):
        kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = decode_many_batched(
            engine.params, cfg, tok.clone(), ref, num_steps=steps,
            done=kw["done"], n_emitted=kw["n_emitted"], limits=kw["limits"],
            eos_tokens=kw["eos_tokens"], qparams=engine.qparams, live_cap=4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if c < chunks - 1:
            got = compiled(state, tok, num_steps=steps, live_cap=4, **host)
            torch.cuda.synchronize()
        else:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                got = compiled(state, tok, num_steps=steps, live_cap=4,
                               **host)
                torch.cuda.synchronize()
        t2 = time.perf_counter()
        toks, _, info, dn, emitted = want
        assert info.critical_masks is None and got.info.critical_masks is None
        assert torch.equal(got.tokens, toks), \
            f"{cfg.name}: graph tokens != eager tokens (chunk {c})"
        assert torch.equal(got.done, dn) and \
            torch.equal(got.n_emitted, emitted)
        for part, cache in ref.items():
            for f, t in cache_tensors(cache):
                assert torch.equal(getattr(state.caches[part], f), t), \
                    (part, f)
        if c == 0:
            rec["first_call_s"] = t2 - t1        # capture and one replay
        elif c == 1:
            rec.update(eager_ms_per_step=(t1 - t0) * 1e3 / steps,
                       graph_ms_per_step=(t2 - t1) * 1e3 / steps)
        else:
            kernels = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            k2 = [e for e in kernels if SYMBOLS["expert_quant_matmul"]
                  in e.key]
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            # idle share against the second chunk's untraced replay (the
            # same kernels): tracing a replay of ~50k kernels slows its
            # wall several times over
            rec.update(
                replay_traced_ms=(t2 - t1) * 1e3, replay_device_busy_ms=busy,
                replay_idle_share=1 - busy / (rec["graph_ms_per_step"]
                                              * steps),
                kernels_per_step=sum(e.count for e in kernels) / steps,
                k2_kernels=sum(e.count for e in k2),
                k2_device_ms=sum(e.self_device_time_total for e in k2) / 1e3,
                top_kernels=[dict(name=e.key[:60], count=e.count,
                                  ms=e.self_device_time_total / 1e3)
                             for e in top[:6]])
        tok = got.tokens[-1].clone()
        host.update(done=got.done.cpu().numpy(),
                    n_emitted=got.n_emitted.cpu().numpy())
    assert host["done"][2] and not host["done"][0]
    compiled.release(state)
    rec.update(caches=sorted(ref), state_bytes=sum(
                   t.numel() * t.element_size()
                   for c in ref.values() for _, t in cache_tensors(c)))
    return rec


# ------------------------------------------------------------------ window

# the reference's long-context window (src/repro/launch/dryrun.py,
# LONG_CONTEXT_WINDOW): every attention layer's cache a ring of 8192 slots
WINDOW = 8192
# 9000 and 8600: the prefill keeps only the last 8192 keys; 8160: the ring
# wraps mid-decode; 2000: it never wraps
WINDOW_PROMPTS = (9000, 8600, 8160, 2000)
WINDOW_NEW = 48
# the dense model's two requests
WINDOW_DENSE_PROMPT = 9000


def _ring_expected(length: int, w: int) -> list:
    """The positions a ring of ``w`` slots holds after ``length`` tokens:
    position p at slot p % w for the last min(length, w), else -1."""
    exp = [-1] * w
    for p in range(max(0, length - w), length):
        exp[p % w] = p
    return exp


def _admission_check(checked: list):
    """A wrapper of the scheduler's ``_inject_rows`` that, after each
    admission, holds every injected row's positions (all layers) to
    ``_ring_expected`` of its length, and appends (length, rows ok)."""
    import torch
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    inner = ContinuousBatchingScheduler._inject_rows

    def check(self, rc, src, dst):
        inner(self, rc, src, dst)
        pos = self._state.caches["layers"].positions      # (L, B, W)
        w = pos.shape[-1]
        for d in dst.tolist():
            length = int(self._state.caches["layers"].length[0, d])
            want = torch.tensor(_ring_expected(length, w), dtype=pos.dtype,
                                device=pos.device)
            assert torch.equal(pos[:, d], want.expand_as(pos[:, d])), \
                f"slot {d}: ring positions after a {length}-token admission"
            checked.append(length)
    return inner, check


def _ring_gate(engine) -> dict:
    """The compiled decode chunk on ring caches at full width: 4 rows of
    8184-token prompts prefilled into rings of ``WINDOW`` slots (one row
    dead, one reaching its limit in the second chunk), then three 16-step
    chunks by eager ``decode_many_batched`` on a copy of the state and by
    the engine's compiled chunk on the state itself; the ring wraps inside
    the first chunk. The first call captures; the second replays under
    ``set_sync_debug_mode("error")``, both timed; the third replays under
    torch.profiler (device busy, K1 kernels = 3 x L x 16). Tokens,
    Critical/active masks, done, emitted and every cache leaf bitwise."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models.kv_cache import cache_tensors
    from repro_torch.models.model import decode_many_batched, prefill

    cfg, dev = engine.cfg, engine.device
    b, s, steps, chunks = 4, WINDOW - 8, 16, 3
    prompts = torch.randint(1, cfg.vocab_size, (b, s), device=dev,
                            generator=torch.Generator(device=dev
                                                      ).manual_seed(9))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, rc, _ = prefill(engine.params, cfg, prompts,
                            qparams=engine.qparams)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    compiled = engine._decode_batched
    state = compiled.acquire(b, WINDOW)
    assert rc["layers"].ring and state.caches["layers"].ring
    ref = {"layers": dataclasses.replace(rc["layers"], **{
        f: x.clone() for f, x in cache_tensors(rc["layers"])})}
    state.load(rc)
    del rc
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    host = dict(done=np.array([False, False, False, True]),
                n_emitted=np.ones(b, np.int32),
                limits=np.array([64, 64, 24, 64], np.int32),
                eos_tokens=np.full(b, -1, np.int32))
    rec = dict(prompt=s, prefill_s=prefill_s)
    for c in range(chunks):
        kw = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = decode_many_batched(
            engine.params, cfg, tok.clone(), ref, num_steps=steps,
            done=kw["done"], n_emitted=kw["n_emitted"], limits=kw["limits"],
            eos_tokens=kw["eos_tokens"], qparams=engine.qparams, live_cap=4)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if c < 2:
            if c == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = compiled(state, tok, num_steps=steps, live_cap=4,
                               **host)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        else:
            res = {}
            kernels = _trace(lambda: res.setdefault("got", compiled(
                state, tok, num_steps=steps, live_cap=4, **host)))
            got = res["got"]
        t2 = time.perf_counter()
        toks, _, info, dn, emitted = want
        assert torch.equal(got.tokens, toks), \
            f"ring chunk {c}: graph tokens != eager tokens"
        for f in ("critical_masks", "active_masks"):
            assert torch.equal(getattr(got.info, f), getattr(info, f)), f
        assert torch.equal(got.done, dn) and \
            torch.equal(got.n_emitted, emitted)
        for f, x in cache_tensors(ref["layers"]):
            assert torch.equal(getattr(state.caches["layers"], f), x), (c, f)
        if c == 0:
            rec["first_call_s"] = t2 - t1         # capture and one replay
        elif c == 1:
            rec.update(eager_ms_per_step=(t1 - t0) * 1e3 / steps,
                       graph_ms_per_step=(t2 - t1) * 1e3 / steps)
        else:
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            k1 = sum(e.count for e in kernels
                     if SYMBOLS["expert_quant_matmul_grouped"] in e.key)
            assert k1 == 3 * cfg.num_layers * steps, k1
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)
            # idle share against the second chunk's untraced replay
            rec.update(replay_device_busy_ms_per_step=busy / steps,
                       replay_idle_share=1 - busy / (
                           rec["graph_ms_per_step"] * steps),
                       kernels_per_step=sum(e.count for e in kernels) / steps,
                       k1_kernels_per_replay=k1,
                       top_kernels=[dict(name=e.key[:60], count=e.count,
                                         ms=e.self_device_time_total / 1e3)
                                    for e in top[:6]])
        tok = got.tokens[-1].clone()
        host.update(done=got.done.cpu().numpy(),
                    n_emitted=got.n_emitted.cpu().numpy())
    assert host["done"][2] and not host["done"][0]
    pos = state.caches["layers"].positions[0, 0].tolist()
    assert sorted(pos) == list(range(s + chunks * steps - WINDOW,
                                     s + chunks * steps)), "ring positions"
    compiled.release(state)
    rec["wrapped_at_step"] = WINDOW - s
    return rec


def _window_serve(engine, reqs, by_rows: int, admissions: list) -> tuple:
    """``generate_batch`` of ``reqs`` on ``by_rows`` slots three times: the
    first (warm: captures the chunk keys, meets the prefill keys) with
    every admission's ring positions checked (``_admission_check``), the
    second captures the prefill keys, the third is counted (launch
    counters reset just before, read just after). Returns (results,
    launches, stats, walls)."""
    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    walls = []
    inner, check = _admission_check(admissions)
    ContinuousBatchingScheduler._inject_rows = check
    try:
        t0 = time.perf_counter()
        warm = engine.generate_batch(reqs, num_slots=by_rows)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    finally:
        ContinuousBatchingScheduler._inject_rows = inner
    t0 = time.perf_counter()
    second = engine.generate_batch(reqs, num_slots=by_rows)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    km.reset_launch_counts()                       # this path starts here
    t0 = time.perf_counter()
    out = engine.generate_batch(reqs, num_slots=by_rows)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    launches = dict(km.LAUNCHES)                   # this path ends here
    stats = dict(engine.last_stats)
    assert [r.tokens for r in out] == [r.tokens for r in warm] == \
        [r.tokens for r in second]
    assert stats["compiles"] == 0 == stats["prefill_compiles"], stats
    assert stats["waves_batched"] == 0, stats      # a ring admits solo
    for r, q in zip(out, reqs):
        assert len(r.tokens) == q.max_new_tokens
        assert all(0 <= v < engine.cfg.vocab_size for v in r.tokens)
    return out, launches, stats, walls


def _window_reduced(dev) -> list:
    """Reduced f32 OLMoE ("4/2"), qwen3_0p6b and zamba2_1p2b with an
    8-token window on the card against the plain path on the CPU:
    ``generate_batch`` (prompts of 20 and 8 tokens, 2 slots, so every ring
    wraps) and ``generate_reference`` tokens and modeled numbers equal."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, Request

    modeled = ("ttft_s", "tpot_s", "cache_stats", "prefill_weight_bytes",
               "decode_weight_bytes_per_tok")
    rows = []
    for arch in ("olmoe_1b_7b", "qwen3_0p6b", "zamba2_1p2b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  sliding_window=8)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        rng = np.random.default_rng(6)
        reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
            1, cfg.vocab_size, s)], max_new_tokens=m)
            for s, m in ((20, 9), (8, 6), (20, 3))]
        engines = [DyMoEEngine(cfg, params, device=d) for d in ("cpu", dev)]
        for name, run in (
                ("generate_batch",
                 lambda e: e.generate_batch(reqs, num_slots=2)),
                ("generate_reference",
                 lambda e: [e.generate_reference(reqs[0])])):
            cpu, gpu = (run(e) for e in engines)
            ct, gt = [r.tokens for r in cpu], [r.tokens for r in gpu]
            assert gt == ct, f"window {arch} {name}: card {gt} != CPU {ct}"
            for i, (c, g) in enumerate(zip(cpu, gpu)):
                for f in modeled:
                    assert getattr(g, f) == getattr(c, f), \
                        f"window {arch} {name} request {i} {f}"
        rows.append(dict(arch=arch, tokens=sum(map(len, ct)),
                         card_equals_cpu=True))
    return rows


def _window_phase(engine) -> dict:
    """Sliding-window ring caches (``window:`` line). (a) Reduced f32
    windowed OLMoE, qwen3_0p6b and zamba2_1p2b, card == CPU
    (``_window_reduced``). (b) Full-width OLMoE-1B-7B ("4/2", the serve
    phase's weights and codes) with a ``WINDOW``-token window, 4 slots,
    16-step chunks: the prefill graph gate on a 9000-token solo admission
    (its ring keeps the last 8192 keys; eager == replay bitwise), the ring
    decode-chunk gate (``_ring_gate``), then ``WINDOW_PROMPTS`` + 48 new
    tokens each through ``generate_batch`` (``_window_serve``: ring
    positions after every admission, K1 = 48 a decode step and K2 = 48 a
    solo admission, exactly). (c) Full-width qwen3_0p6b with the same
    window: 2 requests of 9000 + 48 on 2 slots, K2 = 84 a step and a
    prefill. Returns the counted K1/K2 launches of (b) and (c) by path."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig, Request

    t_phase = time.perf_counter()
    summary = dict(window=WINDOW, reduced=_window_reduced(engine.device))
    summary["reduced_s"] = time.perf_counter() - t_phase
    dev = engine.device
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(engine.cfg, sliding_window=WINDOW)
    L = cfg.num_layers
    eng = DyMoEEngine(cfg, engine.params, EngineConfig(decode_chunk=16),
                      device=dev, qparams=engine.qparams)
    rng = np.random.default_rng(21)
    n = WINDOW_PROMPTS[0]
    gate = _prefill_gate(eng, f"olmoe_1b_7b window solo {n}",
                         rng.integers(1, cfg.vocab_size, (1, n)), {}, WINDOW)
    assert not gate["launch_error"], gate["launch_error"]
    ring = _ring_gate(eng)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, n)], max_new_tokens=WINDOW_NEW)
        for n in WINDOW_PROMPTS]
    admissions = []
    out, launches, stats, walls = _window_serve(eng, reqs, 4, admissions)
    assert sorted(admissions) == sorted(WINDOW_PROMPTS), admissions
    k1, k2 = (launches[k] for k in ("expert_quant_matmul_grouped",
                                    "expert_quant_matmul"))
    assert k1 == 3 * L * stats["decode_steps"], (k1, stats)
    assert k2 == 3 * L * stats["waves_solo"] and stats["waves_solo"] == 4, \
        (k2, stats)
    states = eng._decode_batched.states()
    assert [(st.num_slots, st.slots_len) for st in states] == \
        [(4, WINDOW)], [(st.num_slots, st.slots_len) for st in states]
    peak = torch.cuda.max_memory_allocated()
    kv = states[0].caches["layers"]
    summary["olmoe"] = dict(
        prompts=list(WINDOW_PROMPTS), new_tokens=[len(r.tokens) for r in out],
        serve_walls_s=dict(warm=walls[0], second=walls[1], counted=walls[2]),
        batch=stats, k1_per_decode_step=3 * L, k2_per_admission=3 * L,
        k1_launches=k1, k2_launches=k2,
        decode_wall_ms_per_token=[r.decode_wall_s * 1e3
                                  / (len(r.tokens) - 1) for r in out],
        modeled_edge_ttft_s=[r.ttft_s for r in out],
        modeled_edge_tpot_s=[r.tpot_s for r in out],
        admissions_checked=sorted(admissions), ring_gate=ring,
        prefill_gate=gate,
        state_kv_gib=(kv.k.numel() * kv.k.element_size() * 2) / 2**30,
        max_memory_allocated_gib=peak / 2**30,
        above_start_gib=(peak - base) / 2**30,
        prefill_engine=_prefill_engine("olmoe_1b_7b window", eng._prefill))
    by_path = {"window": launches}
    del eng, out, states, kv
    gc.collect()
    torch.cuda.empty_cache()

    dcfg = dataclasses.replace(get_config("qwen3_0p6b"), sliding_window=WINDOW)
    t0 = time.perf_counter()
    params = init_params(dcfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    deng = DyMoEEngine(dcfg, params, EngineConfig(decode_chunk=16),
                       device=dev)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    dreqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, dcfg.vocab_size, WINDOW_DENSE_PROMPT)], max_new_tokens=WINDOW_NEW)
        for _ in range(2)]
    admissions = []
    out, launches, stats, walls = _window_serve(deng, dreqs, 2, admissions)
    assert admissions == [WINDOW_DENSE_PROMPT] * 2, admissions
    per_step = 3 * dcfg.num_layers
    k2 = launches["expert_quant_matmul"]
    assert launches["expert_quant_matmul_grouped"] == 0, launches
    assert k2 == per_step * (stats["decode_steps"] + stats["waves_solo"]), \
        (k2, stats)
    summary["qwen3_0p6b"] = dict(
        init_quantize_s=init_s, prompts=[WINDOW_DENSE_PROMPT] * 2,
        new_tokens=[len(r.tokens) for r in out],
        serve_walls_s=dict(warm=walls[0], second=walls[1], counted=walls[2]),
        batch=stats, k2_per_step=per_step, k2_launches=k2,
        decode_wall_ms_per_token=[r.decode_wall_s * 1e3
                                  / (len(r.tokens) - 1) for r in out],
        max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    by_path["window_dense"] = launches
    del deng
    summary["phase_s"] = time.perf_counter() - t_phase
    print("window: " + json.dumps(summary), flush=True)
    return by_path


# ---------------------------------------------------------------- frontend


def _launcher_run(launcher, args, engine) -> tuple:
    """One ``repro_torch.launch.serve`` open loop or one-shot on
    ``engine``, its streamed lines kept out of this script's output:
    (report, handles or [result], synchronized host seconds, the slot
    length of its sessions). Fails if a driver thread caught an error
    (``Replica.last_error``: a driver retries past what ``step`` raises,
    so such an error would otherwise pass unseen)."""
    import contextlib
    import io

    import torch
    with contextlib.redirect_stdout(io.StringIO()):
        t0 = time.perf_counter()
        report, handles, session = launcher.run(args, engine)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    replicas = getattr(session, "replicas", None)
    errors = [repr(rep.last_error) for rep in replicas or ()
              if rep.last_error is not None]
    assert not errors, errors
    slots = None if session is None else {
        (rep.session if replicas else session)._slots_len
        for rep in replicas or [None]}
    return report, handles, wall, slots


def _solo_at(engine, reqs, slots_len: int) -> tuple:
    """Each request alone: a one-slot session of ``slots_len`` slots
    (rounded up as every session's are), as ``generate`` opens, but at a
    slot length the caller names. (tokens, the sessions' slot length)."""
    out, slots = [], set()
    for r in reqs:
        session = engine.serve(num_slots=1, slots_len=slots_len)
        slots.add(session._slots_len)
        out.append(session.run([r])[0].tokens)
    return out, slots


def _static_vs_continuous(engine) -> dict:
    """The reference's ``continuous_vs_static`` row on the card: 8 ragged
    requests (two 64-token stragglers among short ones, prompts of 8, 16
    or 24 tokens, as ``benchmarks/bench_e2e_latency.py`` draws them)
    through ``generate_batch(static=True)`` and through continuous
    batching on 4 slots, each warm (its second run timed): walls and
    decode tokens a second."""
    import numpy as np
    import torch
    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    specs = [(16, 64), (24, 64)] + [(int(rng.choice([8, 16, 24])),
                                     int(rng.integers(3, 7)))
                                    for _ in range(6)]
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, engine.cfg.vocab_size, s)], max_new_tokens=m) for s, m in specs]
    out = {}
    for mode in ("static", "continuous", "static", "continuous"):
        t0 = time.perf_counter()
        res = (engine.generate_batch(reqs, static=True) if mode == "static"
               else engine.generate_batch(reqs, num_slots=4))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert [len(r.tokens) for r in res] == [m for _, m in specs]
        new = sum(len(r.tokens) - 1 for r in res)
        out[mode] = dict(wall_s=wall, decode_tok_s=new / wall,
                         new_tokens=new)
    out["speedup_vs_static"] = (out["continuous"]["decode_tok_s"]
                                / out["static"]["decode_tok_s"])
    out["specs"] = specs
    return out


def _decode_many_gate(engine) -> dict:
    """The compiled ``decode_many`` at full width: a 64-token prompt's
    prefill caches copied into a decode state, then three 16-step calls
    of one greedy key (eager first call, capture and replay, replay under
    ``set_sync_debug_mode("error")``) against eager ``decode_many`` from
    a copy of the same caches: tokens, telemetry and caches bitwise, and
    3 x L x 16 K2 launches a call."""
    import dataclasses

    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.models.kv_cache import cache_tensors
    from repro_torch.models.model import decode_many, prefill

    cfg, dev = engine.cfg, engine.device
    L, steps, slots = cfg.num_layers, 16, 128
    prompt = torch.arange(101, 165, device=dev)[None]
    logits, rc, _ = prefill(engine.params, cfg, prompt,
                            qparams=engine.qparams, cache_slots=slots)
    ref = {"layers": dataclasses.replace(rc["layers"], **{
        f: t.clone() for f, t in cache_tensors(rc["layers"])})}
    cm = engine._decode_many
    with engine.lock:
        state = cm.acquire(1, slots, caches=rc)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    times = []
    try:
        for call in range(3):
            start = 1 + call * steps
            want_t, _, want_i = decode_many(
                engine.params, cfg, tok.clone(), ref, num_steps=steps,
                start_step=start, qparams=engine.qparams)
            before = dict(km.LAUNCHES)
            torch.cuda.synchronize()
            if call == 2:
                torch.cuda.set_sync_debug_mode("error")
            t0 = time.perf_counter()
            try:
                with engine.lock:
                    out = cm(state, tok, num_steps=steps, start_step=start)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            k2 = km.LAUNCHES["expert_quant_matmul"] - \
                before["expert_quant_matmul"]
            assert k2 == 3 * L * steps, (call, k2)
            assert torch.equal(out.tokens, want_t), call
            for f in ("critical_masks", "active_masks", "gate_mean",
                      "predicted_next"):
                assert torch.equal(getattr(out.info, f),
                                   getattr(want_i, f)), (call, f)
            for f, t in cache_tensors(ref["layers"]):
                assert torch.equal(getattr(state.caches["layers"], f), t), f
            tok = out.tokens[-1].clone()
    finally:
        with engine.lock:
            cm.release(state)
    return dict(bitwise=True, calls_ms=times, k2_per_call=3 * L * steps)


def _tokens_equal(a, b) -> dict:
    """How many of two lists of token lists agree, and where each first
    differs (None where it does not)."""
    first = [next((i for i, (u, v) in enumerate(zip(x, y)) if u != v),
                  None if len(x) == len(y) else min(len(x), len(y)))
             for x, y in zip(a, b)]
    return dict(equal=sum(f is None for f in first), of=len(a),
                first_diff=first)


def _dropless(engine):
    """``engine``'s model as an engine on the same weights (and store)
    with ``capacity_factor`` E / k: no token is dropped however a batch
    is made, the row-independent regime of the reference's static-batch
    contract (``tests/test_serving_api.py``'s config, E 8 top-2 at 4.0)."""
    import dataclasses

    from repro_torch.serving import DyMoEEngine
    cfg = engine.cfg
    return DyMoEEngine(dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok),
        engine.params, engine.ecfg, device=engine.device,
        qparams=engine.qparams)


def _frontend_phase(dev) -> tuple:
    """The serving front end at full width (``olmoe_1b_7b``, 16 layers,
    the launcher's seeded weights), the ``frontend:`` line; each part
    fails the run if it fails. A launcher run fails if any driver thread
    caught an error (``_launcher_run``). First on the launcher's own
    engine (bf16, "4/2", the serving dtype):

    the bf16 token check: each request of the launcher's loop (``--full
        --requests 8``) alone at the loop's slot length (``_solo_at``,
        checked equal to ``generate``) against the loop with 2 replicas
        of 1 slot (driver threads; gated: every request's solo tokens),
        2 replicas of 2 slots and 1 replica of 2 slots (reported: a
        request's tokens with another row in its batch);
    (c) ``generate_reference`` through ``CompiledDecodeMany``: the graph
        gate (``_decode_many_gate``), then a 64-token prompt with 33 new
        tokens through the eager protocol (``graphs=False``) and through
        the graphs (after a warm call): equal tokens and modeled numbers,
        K2 launches exactly 3 x L x 33, no K1; ms a token of each;
    and the reference's ``continuous_vs_static`` row. Then on the same
    config in f32 (its own engine, weights drawn as the launcher draws
    them), where a row's tokens do not depend on its batch:

    (a) the launcher's open loop (``repro_torch.launch.serve``: ``--full
        --requests 8 --replicas 2 --num-slots 2``, driver threads): a cold
        run (it captures, in the driver threads), then a counted one:
        every request's tokens equal the same engine's solo ``generate``,
        both replicas serve, every request completes, K1 runs; the same
        loop with one replica for the wall beside it;
    (b) ``--mode off`` (full precision; the same weights, no packed
        store): the one-shot equals ``generate_reference``, and
        ``generate_batch(static=True)`` over the launcher's 8 requests
        gives every row ``generate_reference``'s tokens in the dropless
        regime (``_dropless``; at the config's capacity factor the count
        is reported); no K1 or K2 launch;
    (d) a replica fault under driver threads: two replicas, one with a
        ``replay.chunk`` fault; every handle resolves, the faulted replica
        is drained and cold-restarted once, results keep solo tokens, and
        two requests after it resolve with solo tokens.

    Returns ({path: launch counts}, the summary)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import init_params
    from repro_torch.serving import ClusterRouter, DyMoEEngine, \
        FaultInjector, FaultSpec, ServingError
    from repro_torch.serving.compiled import CompiledDecodeMany

    argv = ["--full", "--requests", "8"]
    loop = argv + ["--replicas", "2", "--num-slots", "2"]
    paths, summary = {}, {}

    # ---- bf16: what holds at the serving dtype, (c), continuous vs static
    args16 = launcher.parse_args(loop)
    t0 = time.perf_counter()
    engine = launcher.build_engine(args16)
    torch.cuda.synchronize()
    summary["bf16_init_s"] = time.perf_counter() - t0
    cfg, ecfg = engine.cfg, engine.ecfg
    L = cfg.num_layers
    assert L == 16 and cfg.d_model == 2048 and cfg.dtype == "bfloat16", cfg
    report, handles, _, slots22 = _launcher_run(launcher, args16, engine)
    reqs = [h.request for h in handles]
    slots_len = args16.prompt_len + args16.max_new + args16.requests
    solo16, solo_slots = _solo_at(engine, reqs, slots_len)
    assert solo_slots == slots22, (solo_slots, slots22)
    assert [engine.generate(r).tokens for r in reqs] == solo16
    bf16 = {"slots_len": sorted(slots22), "replicas_2_slots_2":
            _tokens_equal([h.result().tokens for h in handles], solo16)}
    for label, extra in (("replicas_2_slots_1", ["--replicas", "2",
                                                 "--num-slots", "1"]),
                         ("replicas_1_slots_2", ["--replicas", "1",
                                                 "--num-slots", "2"])):
        _, hs, _, slots = _launcher_run(
            launcher, launcher.parse_args(argv + extra), engine)
        assert slots == slots22, (label, slots)
        bf16[label] = _tokens_equal([h.result().tokens for h in hs], solo16)
    summary["bf16_vs_solo"] = bf16
    print("frontend_bf16: " + json.dumps(bf16), flush=True)
    one_slot = bf16["replicas_2_slots_1"]
    assert one_slot["equal"] == one_slot["of"] == 8, one_slot
    summary["decode_many_gate"] = _decode_many_gate(engine)
    req = dataclasses.replace(reqs[0], prompt_tokens=list(range(101, 165)),
                              max_new_tokens=33, request_id="ref")
    graphs = engine._decode_many
    ref_runs = {}
    for label, cm in (("eager", CompiledDecodeMany(engine, graphs=False)),
                      ("graph", graphs)):
        engine._decode_many = cm
        engine.generate_reference(req)                 # warm
        torch.cuda.synchronize()
        km.reset_launch_counts()     # the (c) path starts here
        r = engine.generate_reference(req)
        torch.cuda.synchronize()
        counts = dict(km.LAUNCHES)   # ... and ends here
        assert counts["expert_quant_matmul"] == 3 * L * 33, counts
        assert counts["expert_quant_matmul_grouped"] == 0, counts
        ref_runs[label] = (r, counts)
    engine._decode_many = graphs
    (er, _), (gr, gcounts) = ref_runs["eager"], ref_runs["graph"]
    assert gr.tokens == er.tokens
    assert (gr.ttft_s, gr.tpot_s, gr.cache_stats) == \
        (er.ttft_s, er.tpot_s, er.cache_stats)
    paths["frontend_reference"] = gcounts
    summary["generate_reference"] = dict(
        new_tokens=len(gr.tokens), compiles=graphs.compiles,
        compile_s=graphs.compile_s, pool_bytes=graphs.pool_bytes(),
        **{f"{k}_ms_per_token": v.decode_wall_s * 1e3 / (len(v.tokens) - 1)
           for k, (v, _) in ref_runs.items()})
    summary["continuous_vs_static"] = _static_vs_continuous(engine)
    del engine, handles, report
    gc.collect()
    torch.cuda.empty_cache()

    # ---- f32: (a), (b), (d)
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    engine = DyMoEEngine(cfg32, init_params(cfg32, gen, dev), ecfg,
                         device=dev)
    torch.cuda.synchronize()
    summary["f32_init_s"] = time.perf_counter() - t0

    # (a) the launcher's open loop over two replicas on driver threads
    args = launcher.parse_args(loop)
    _, _, cold, _ = _launcher_run(launcher, args, engine)
    km.reset_launch_counts()                 # the (a) path starts here
    report, handles, wall2, _ = _launcher_run(launcher, args, engine)
    paths["frontend_serve"] = dict(km.LAUNCHES)   # ... and ends here
    got = [h.result().tokens for h in handles]
    solo = [engine.generate(h.request).tokens for h in handles]
    assert got == solo, _tokens_equal(got, solo)
    assert {r["replica"] for r in report["requests"]} == {0, 1}
    assert report["health"]["merged"]["completed"] == 8
    assert all("error" not in r for r in report["requests"])
    assert paths["frontend_serve"]["expert_quant_matmul_grouped"] > 0
    args1 = launcher.parse_args(argv + ["--replicas", "1", "--num-slots",
                                        "2"])
    _launcher_run(launcher, args1, engine)
    _, handles1, wall1, _ = _launcher_run(launcher, args1, engine)
    assert [h.result().tokens for h in handles1] == solo
    summary["serve"] = dict(
        argv=loop, dtype="float32",
        replicas_2=dict(cold_wall_s=cold, wall_s=wall2),
        replicas_1=dict(wall_s=wall1), health=report["health"]["merged"],
        placements=[r["replica"] for r in report["requests"]],
        tokens_equal_solo=True)

    # (b) full precision: the one-shot and the static baseline, on the
    # engine ``--mode off`` builds, over the same weights
    off_args = launcher.parse_args(["--full", "--mode", "off"])
    off = DyMoEEngine(
        dataclasses.replace(cfg32, dymoe=dataclasses.replace(
            cfg32.dymoe, enabled=False)),
        engine.params, dataclasses.replace(ecfg, use_dymoe=False,
                                           enable_dyquant=False),
        device=dev)
    assert off.qparams is None and not off.cfg.dymoe.enabled
    km.reset_launch_counts()                 # the (b) path starts here
    one, (res,), one_wall, _ = _launcher_run(launcher, off_args, off)
    # the one-shot serves the launcher's request 0, which is reqs[0]
    assert res.tokens == off.generate_reference(reqs[0]).tokens
    static_cf = [r.tokens for r in off.generate_batch(reqs, static=True)]
    refs_cf = [off.generate_reference(r).tokens for r in reqs]
    dropless = _dropless(off)
    refs = [dropless.generate_reference(r).tokens for r in reqs]
    dropless.generate_batch(reqs, static=True)               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static = dropless.generate_batch(reqs, static=True)
    torch.cuda.synchronize()
    static_wall = time.perf_counter() - t0
    paths["frontend_off"] = dict(km.LAUNCHES)     # ... and ends here
    assert not any(paths["frontend_off"].values()), paths["frontend_off"]
    assert [r.tokens for r in static] == refs, \
        _tokens_equal([r.tokens for r in static], refs)
    summary["off"] = dict(
        one_shot=dict(ttft_ms=one["ttft_ms"], tpot_ms=one["tpot_ms"],
                      wall_s=one_wall),
        static_wall_s=static_wall, static_rows_equal_reference=True,
        capacity_factor=dropless.cfg.capacity_factor,
        at_config_capacity=dict(capacity_factor=off.cfg.capacity_factor,
                                **_tokens_equal(static_cf, refs_cf)))
    del off, dropless

    # (d) a replica fault under driver threads
    faulty = FaultInjector([FaultSpec(site="replay.chunk", at=1)])
    router = ClusterRouter.replicate(
        engine, 2, num_slots=2, slots_len=128, faults=[None, faulty],
        threaded=True)
    km.reset_launch_counts()                 # the (d) path starts here
    try:
        first = [router.submit(r) for r in reqs]
        results = {}
        for i, h in enumerate(first):
            try:
                results[i] = h.result().tokens
            except ServingError:
                pass
        assert all(h.done for h in first)
        for _ in range(1000):               # the driver restarts it idle
            if router.health().restarts:
                break
            time.sleep(0.01)
        after = [router.submit(dataclasses.replace(
            r, request_id=f"after-{i}")) for i, r in enumerate(reqs[:2])]
        after_tokens = [h.result().tokens for h in after]
        health = router.health()
        errors = [rep.last_error for rep in router.replicas]
    finally:
        router.close()
    paths["frontend_fault"] = dict(km.LAUNCHES)   # ... and ends here
    assert not any(errors), errors
    assert health.restarts == 1 and health.merged.replay_faults >= 1, \
        health
    assert 0 < len(results) < len(reqs), sorted(results)
    assert all(results[i] == solo[i] for i in results)
    assert after_tokens == solo[:2]
    summary["fault"] = dict(resolved=len(first), failed=len(reqs)
                            - len(results), restarts=health.restarts,
                            replay_faults=health.merged.replay_faults,
                            status=health.status)
    summary["launches"] = paths
    print("frontend: " + json.dumps(summary), flush=True)
    del engine
    return paths, summary


# ------------------------------------------------------------------- train

# (arch, layers kept or None for the published depth, batch): bf16, remat
# "block", TRAIN_SEQ tokens a row. Cuts: OLMoE-1B-7B's 16 layers would need
# ~83 GB of bf16 params and grads and f32 AdamW moments, more than the
# card; zamba2_1p2b at batch 4 took 15.7-16.7 s an eager step (555k
# kernels, 77 % idle), 80 s of the phase, so it trains one row
TRAIN_FULL = (("olmoe_1b_7b", 4, 4), ("qwen3_0p6b", None, 4),
              ("zamba2_1p2b", None, 1))
TRAIN_BATCH = 4
TRAIN_SEQ = 512


class _NormAdamW:
    """An optimizer that records each step's global grad norm (as a device
    scalar, read after the timed steps) and hands the update to AdamW."""

    def __init__(self, opt):
        self.opt, self.norms = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, params, grads, state):
        import torch
        from repro_torch.tree import tree_leaves
        self.norms.append(torch.sqrt(sum(
            torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(grads))))
        return self.opt.update(params, grads, state)


def _train_parity(dev) -> dict:
    """(a) Five steps of the reduced f32 OLMoE-1B-7B's ``TrainLoop`` on the
    card and on the CPU, from the same params (drawn on the CPU) and the
    same synthetic batches (4 x 32, lr 1e-2): each step's loss, ce and aux
    agree to rtol 1e-4 (TF32 off). Losses, not params: Adam's first steps
    are near lr · sign(g), so a grad near zero can flip an element by 2 lr
    between devices."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.training import TrainLoop, TrainLoopConfig
    from repro_torch.tree import tree_map

    cfg = get_config("olmoe_1b_7b").reduced()
    lc = TrainLoopConfig(steps=5, lr=1e-2, warmup=1, log_every=1)
    cpu = TrainLoop(cfg, lc, device="cpu")
    card = TrainLoop(cfg, lc, device=dev)
    card.params = tree_map(lambda p: p.to(dev), cpu.params)
    card.opt_state = card.optimizer.init(card.params)
    dc = DataConfig(batch_size=4, seq_len=32, vocab_size=cfg.vocab_size)
    cpu.run(synthetic_lm_batches(dc))
    card.run(synthetic_lm_batches(dc))
    worst = 0.0
    for c, g in zip(cpu.history, card.history):
        for k in ("loss", "ce", "aux"):
            rel = abs(g[k] - c[k]) / abs(c[k])
            assert rel <= 1e-4, f"step {c['step']} {k}: card {g[k]} != " \
                                f"CPU {c[k]} (rel {rel:.2e} > 1e-4)"
            worst = max(worst, rel)
    return dict(steps=len(card.history), rtol=1e-4, max_rel=worst,
                loss_card=[h["loss"] for h in card.history],
                loss_cpu=[h["loss"] for h in cpu.history])


def _train_full(dev, arch: str, layers, batch: int) -> dict:
    """(b) Train steps of ``arch`` at full width (bf16, remat "block", the
    config's own), ``batch`` x ``TRAIN_SEQ`` synthetic tokens: one warm-up
    step, three timed (CUDA events around the step: the host's time is in
    it), then one under torch.profiler (device busy = the sum of its CUDA
    kernels' time, one stream; idle share = 1 - busy / that step's wall).
    Every loss and grad norm must be finite. Peak memory over all five."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.models.model import init_params, train_step_fn
    from repro_torch.training import AdamW, cosine_lr
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    cuts = []
    if layers is not None and layers < cfg.num_layers:
        cuts.append(f"{layers} of {cfg.num_layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if batch < TRAIN_BATCH:
        cuts.append(f"batch {batch} of {TRAIN_BATCH}")
    assert cfg.remat == "block" and cfg.dtype == "bfloat16", cfg
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_run = t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    opt = _NormAdamW(AdamW(lr=cosine_lr(3e-4, 20, 100), weight_decay=0.01))
    state = opt.init(params)
    step = train_step_fn(cfg, opt)
    batches = synthetic_lm_batches(DataConfig(batch, TRAIN_SEQ,
                                              cfg.vocab_size, seed=0))
    data = [{k: torch.as_tensor(v, device=dev) for k, v in next(
        batches).items()} for _ in range(5)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    losses, ms = [], []
    for i, b in enumerate(data[:4]):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        params, state, m = step(params, state, b)
        e.record()
        e.synchronize()
        losses.append(m["loss"])
        if i:                                   # step 0 is the warm-up
            ms.append(a.elapsed_time(e))
    walls = []

    def profiled():
        nonlocal params, state
        t = time.perf_counter()
        params, state, m = step(params, state, data[4])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        losses.append(m["loss"])

    t_trace = time.perf_counter()
    kernels = _trace(profiled)
    trace_s = time.perf_counter() - t_trace
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    losses = [float(v) for v in losses]
    norms = [float(v) for v in opt.norms]
    assert all(map(math.isfinite, losses + norms)), (losses, norms)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    n_params = sum(p.numel() for p in tree_leaves(params))
    out = dict(
        arch=arch, layers=cfg.num_layers, batch=batch, seq=TRAIN_SEQ,
        cuts=cuts, params=n_params, init_s=init_s, step_ms=ms,
        loss=losses, grad_norm=norms, profiled_wall_ms=walls[0] * 1e3,
        device_busy_ms=busy_ms, idle_share=1 - busy_ms / (walls[0] * 1e3),
        kernels_a_step=sum(e.count for e in kernels),
        peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        trace_s=trace_s, run_s=time.perf_counter() - t_run,
        top_kernels=[dict(name=e.key[:60], count=e.count,
                          ms=e.self_device_time_total / 1e3) for e in top])
    del params, state, data, step, opt
    return out


def _load_skew(params, cfg, tokens) -> list:
    """Each layer's share of the expert load that its top-k experts take
    (k = experts a token), from a full-precision prefill of ``tokens``:
    k / E when the load is uniform, 1 when k experts take it all."""
    from repro_torch.models.model import prefill
    _, _, info = prefill(params, cfg, tokens)
    load = info.expert_load                                      # (L, E)
    top = load.sort(dim=-1, descending=True).values
    return (top[:, :cfg.num_experts_per_tok].sum(-1)
            / load.sum(-1)).tolist()


def _train_serve(dev) -> dict:
    """(c) A ``TrainLoop`` on the reduced f32 OLMoE-1B-7B (60 steps, lr
    1e-2, warmup 5, 4 x 32) lowers the loss by >= 0.3 (the bar of
    ``tests/test_train.py::test_loss_decreases``) and writes its final
    checkpoint; ``load_checkpoint`` restores it bit for bit; engines on the
    restored and on the in-memory params ("4/2") serve the same 4 requests
    on 2 slots to the same tokens, launching K1 (the first, batched
    admission and the decode chunks) and K2 (the later admissions, one
    request each: their lengths stagger the finishes across chunk
    boundaries). Returns the launch counts of the serve from the restored
    params."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km
    from repro_torch.serving import DyMoEEngine, Request
    from repro_torch.training import TrainLoop, TrainLoopConfig, \
        latest_step, load_checkpoint
    from repro_torch.tree import tree_map, tree_paths

    cfg = get_config("olmoe_1b_7b").reduced()
    held_out = next(synthetic_lm_batches(DataConfig(
        8, 64, cfg.vocab_size, seed=99)))["tokens"]
    held_out = torch.as_tensor(held_out, device=dev)
    with tempfile.TemporaryDirectory() as d:
        loop = TrainLoop(cfg, TrainLoopConfig(
            steps=60, lr=1e-2, warmup=5, log_every=5, checkpoint_dir=d),
            device=dev)
        skew_init = _load_skew(loop.params, cfg, held_out)
        res = loop.run(synthetic_lm_batches(DataConfig(
            batch_size=4, seq_len=32, vocab_size=cfg.vocab_size)))
        first, last = loop.history[0]["loss"], loop.history[-1]["loss"]
        assert last < first - 0.3, f"loss {first} -> {last}: < 0.3 drop"
        step = latest_step(d)
        restored, got_step = load_checkpoint(d, step, tree_map(
            torch.empty_like, loop.params))
    assert step == got_step == 60
    for k, v in tree_paths(loop.params).items():
        r = tree_paths(restored)[k]
        assert r.dtype == v.dtype and r.device == v.device and \
            torch.equal(r.view(torch.uint8), v.contiguous().view(
                torch.uint8)), k
    skew_trained = _load_skew(restored, cfg, held_out)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt_tokens=[int(v) for v in rng.integers(
        1, cfg.vocab_size, int(s))], max_new_tokens=int(m))
        for s, m in ((9, 6), (17, 40), (5, 8), (12, 20))]
    served = {}
    for label, params in (("memory", loop.params), ("restored", restored)):
        engine = DyMoEEngine(cfg, params, device=dev)
        engine.generate_batch(reqs, num_slots=2)                 # warm
        torch.cuda.synchronize()
        km.reset_launch_counts()     # the train-then-serve path starts here
        out = engine.generate_batch(reqs, num_slots=2)
        torch.cuda.synchronize()
        served[label] = ([r.tokens for r in out], dict(km.LAUNCHES))
    (mem, _), (tok, launches) = served["memory"], served["restored"]
    assert tok == mem, f"restored tokens {tok} != in-memory {mem}"
    assert launches["expert_quant_matmul_grouped"] > 0 and \
        launches["expert_quant_matmul"] > 0, launches
    print("train_skew: " + json.dumps(dict(
        what="share of each layer's expert load on its top-k experts "
             f"(k={cfg.num_experts_per_tok} of {cfg.num_experts}), "
             "full-precision prefill of 8 x 64 held-out synthetic tokens",
        init=skew_init, trained=skew_trained)), flush=True)
    return dict(loss_first=first, loss_last=last, wall_s=res["wall_s"],
                checkpoint_step=step, restored_bitwise=True,
                requests_equal=len(tok), new_tokens=sum(map(len, tok)),
                launches=launches)


def _train_phase(dev) -> dict:
    """The training path (``train:`` line): (a) card == CPU losses, (b)
    full-width steps, (c) train, checkpoint, restore and serve. Returns the
    K1/K2 launch counts of (c)'s counted serve."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    summary = dict(allocated_at_start_gib=torch.cuda.memory_allocated()
                   / 2 ** 30, parity=_train_parity(dev))
    summary["parity_s"] = time.perf_counter() - t0
    summary["full"] = [_train_full(dev, *run) for run in TRAIN_FULL]
    t1 = time.perf_counter()
    serve = _train_serve(dev)
    launches = serve.pop("launches")
    summary.update(serve=serve, serve_s=time.perf_counter() - t1,
                   launches=launches, phase_s=time.perf_counter() - t0)
    print("train: " + json.dumps(summary), flush=True)
    return launches


EP_RANKS = 4
# the full-width loop of the expert_parallel phase: the launcher's flow
EP_ARGV = ["--full", "--requests", "3", "--num-slots", "2", "--prompt-len",
           "64", "--max-new", "8"]


def _ep_requests() -> list:
    """The reduced gate's requests: four ragged prompts (12-21 tokens),
    4-7 new tokens, through 2 slots."""
    from repro_torch.serving import Request
    return [Request(prompt_tokens=list(range(1 + i, 13 + 4 * i)),
                    max_new_tokens=4 + i, request_id=f"req-{i}")
            for i in range(4)]


def _ep_served(engine, reqs) -> dict:
    """``generate_batch`` over 2 slots and one ``generate``: every
    request's tokens and modeled TTFT/TPOT, and each replay's Critical and
    active masks (in replay order)."""
    import numpy as np

    masks, inner = [], engine._replay

    def rec(crit, active, pred, **kw):
        masks.append((np.asarray(crit, bool).tolist(),
                      np.asarray(active, bool).tolist()))
        return inner(crit, active, pred, **kw)

    engine._replay = rec
    try:
        res = engine.generate_batch(reqs, num_slots=2) + [
            engine.generate(reqs[-1])]
    finally:
        engine._replay = inner
    return dict(rows=[(r.tokens, r.ttft_s, r.tpot_s) for r in res],
                masks=masks)


def _routed_bytes(engine) -> int:
    """Bytes of the routed experts' packed store this process holds (its
    block of each split leaf)."""
    total = 0
    for mp in engine.qparams["layers"]["moe"].values():
        for qt in (mp.high, mp.low):
            if qt is None:
                continue
            for t in (qt.packed, qt.scales):
                t = getattr(t, "local", t)
                total += t.numel() * t.element_size()
    return total


def _ep_get_config(launcher, dtype: str):
    """``launcher.get_config`` with the config's dtype set to ``dtype``."""
    import dataclasses

    real = launcher.get_config
    return lambda name: dataclasses.replace(real(name), dtype=dtype)


class _TimedChunks:
    """``engine._decode_batched`` with each decode chunk timed (host clock
    between two synchronizes) and, over a mesh, its collectives counted;
    everything else delegated."""

    def __init__(self, inner, mesh):
        self._inner, self._mesh = inner, mesh
        self.s, self.steps, self.collectives, self.collective_s = \
            0.0, 0, 0, 0.0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, state, tokens, **kw):
        import torch

        torch.cuda.synchronize()
        m = self._mesh
        c0, s0 = (m.collectives, m.collective_s) if m else (0, 0.0)
        t0 = time.perf_counter()
        out = self._inner(state, tokens, **kw)
        torch.cuda.synchronize()
        self.s += time.perf_counter() - t0
        self.steps += kw["num_steps"]
        if m:
            self.collectives += m.collectives - c0
            self.collective_s += m.collective_s - s0
        return out


def _ep_full(launcher, args, engine, mesh=None) -> dict:
    """The launcher's open loop on ``engine`` (its output kept out of this
    script's), counted: K1/K2 launches from 0, tokens, the decode chunks'
    seconds and steps (graph replays on one rank, eager over a mesh) and
    — over a mesh — their collectives. On one rank a warm run first
    captures the keys (a capture's warm-up step launches K1)."""
    from repro_torch.kernels.quant_matmul import expert_quant_matmul as km

    if mesh is None:
        _launcher_run(launcher, args, engine)
    chunks = engine._decode_batched = _TimedChunks(engine._decode_batched,
                                                   mesh)
    km.reset_launch_counts()                   # the path starts here
    report, handles, wall, _ = _launcher_run(launcher, args, engine)
    launches = dict(km.LAUNCHES)               # ... and ends here
    engine._decode_batched = chunks._inner
    steps = max(chunks.steps, 1)
    return dict(tokens=[h.result().tokens for h in handles],
                n_devices=report["n_devices"],
                expert_parallel=report["expert_parallel"], wall_s=wall,
                launches=launches, routed_bytes=_routed_bytes(engine),
                decode_steps=chunks.steps,
                ms_per_step=chunks.s / steps * 1e3,
                collectives_per_step=chunks.collectives / steps,
                collective_s=chunks.collective_s,
                collective_share=(chunks.collective_s / chunks.s
                                  if chunks.s else None))


def _ep_rank(rank: int, device, cfg, reqs) -> dict:
    """One of ``EP_RANKS`` gloo ranks sharing the card: the reduced gate
    (expert- and tensor-parallel engines on this rank's shards of weights
    drawn as the parent draws them), then the launcher's ``--full
    --expert-parallel`` flow in f32 and in bf16."""
    import gc

    import torch
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import make_sim_mesh
    from repro_torch.models.model import init_sharded
    from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig

    mesh = make_sim_mesh(EP_RANKS)
    out = dict(rank=rank)
    for ep in (True, False):
        gen = torch.Generator(device=device).manual_seed(0)
        p, q = init_sharded(cfg, gen, mesh, expert_parallel=ep,
                            device=device)
        eng = DyMoEEngine(cfg, p, EngineConfig(
            profile=EdgeProfile().with_vram(12), decode_chunk=4),
            device=device, qparams=q, mesh=mesh, expert_parallel=ep)
        out["reduced_" + ("ep" if ep else "tp")] = _ep_served(eng, reqs)
        del eng, p, q
    real = launcher.get_config
    for dtype in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launcher.get_config = _ep_get_config(launcher, dtype)
        try:
            args = launcher.parse_args(EP_ARGV + [
                "--expert-parallel", "--device", str(device)])
            t0 = time.perf_counter()
            engine = launcher.build_engine(args, mesh)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        finally:
            launcher.get_config = real
        run = _ep_full(launcher, args, engine, mesh)
        run.update(build_s=build_s, compiles=engine._decode_batched.compiles
                   + engine._prefill.compiles,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        out[dtype] = run
        del engine
    return out


def _expert_parallel_phase(dev) -> dict:
    """Expert-parallel serving over a (1, 4) mesh of gloo ranks sharing
    the one card (``expert_parallel:`` line), against one-rank runs of
    the same weights. Reduced gate: f32 qwen2_moe_a2p7b (4 experts, 1
    shared) expert- and tensor-parallel — every rank's tokens, replay
    masks and modeled TTFT/TPOT equal the one-rank CPU run's. Full width:
    olmoe_1b_7b "4/2" (16 layers, 64 experts: 16 a rank) through the
    launcher's ``--full --expert-parallel`` open loop, in f32 (tokens
    gated equal to the one-rank run of the same requests) and bf16 (the
    match count reported: bf16 tokens depend on the batch); each rank's
    routed store exactly 1/4 of the one-rank store and its K1/K2 launches
    equal the one-rank run's. Returns the launch counts of rank 0's bf16
    run (the serving dtype)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EdgeProfile, EngineConfig

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config("qwen2_moe_a2p7b").reduced()
    reqs = _ep_requests()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    cpu = DyMoEEngine(cfg, params, EngineConfig(
        profile=EdgeProfile().with_vram(12), decode_chunk=4), device="cpu")
    want = _ep_served(cpu, reqs)
    del cpu, params
    one = {}
    real = launcher.get_config
    for dtype in ("float32", "bfloat16"):
        gc.collect()
        torch.cuda.empty_cache()
        launcher.get_config = _ep_get_config(launcher, dtype)
        try:
            args = launcher.parse_args(EP_ARGV + ["--device", str(dev)])
            engine = launcher.build_engine(args)
        finally:
            launcher.get_config = real
        one[dtype] = _ep_full(launcher, args, engine)
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_ep_rank, EP_RANKS, cfg, reqs, device=str(dev),
                  timeout_s=300.0)
    ranks_s = time.perf_counter() - t0
    per_rank, bf16_match = [], []
    for r in ranks:
        for mode in ("reduced_ep", "reduced_tp"):
            assert r[mode] == want, (r["rank"], mode)
        for dtype in ("float32", "bfloat16"):
            run, ref = r[dtype], one[dtype]
            assert run["n_devices"] == EP_RANKS and run["expert_parallel"]
            assert run["routed_bytes"] * EP_RANKS == ref["routed_bytes"], \
                (dtype, run["routed_bytes"], ref["routed_bytes"])
            assert run["launches"] == ref["launches"], \
                (dtype, run["launches"], ref["launches"])
            assert run["launches"]["expert_quant_matmul_grouped"] > 0
            assert run["launches"]["expert_quant_matmul"] > 0
            assert run["compiles"] == 0
        assert r["float32"]["tokens"] == one["float32"]["tokens"], r["rank"]
        bf16_match.append(sum(a == b for a, b in zip(
            r["bfloat16"]["tokens"], one["bfloat16"]["tokens"])))
        per_rank.append(dict(rank=r["rank"], **{
            dtype: {k: r[dtype][k] for k in (
                "routed_bytes", "peak_gib", "launches", "build_s", "wall_s",
                "decode_steps", "ms_per_step", "collectives_per_step",
                "collective_s", "collective_share")}
            for dtype in ("float32", "bfloat16")}))
    summary = dict(
        ranks=EP_RANKS, backend="gloo", reduced=dict(
            config="qwen2_moe_a2p7b reduced f32", modes=["ep", "tp"],
            requests=len(reqs), equal=True),
        one_rank={d: {k: one[d][k] for k in ("routed_bytes", "launches",
                                             "wall_s", "decode_steps",
                                             "ms_per_step")} for d in one},
        f32_tokens_equal=True,
        bf16_tokens_match=f"{min(bf16_match)}/{len(one['bfloat16']['tokens'])}",
        per_rank=per_rank, ranks_s=ranks_s,
        phase_s=time.perf_counter() - t_phase)
    print("expert_parallel: " + json.dumps(summary), flush=True)
    return ranks[0]["bfloat16"]["launches"]


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
    records["expert_quant_matmul"] += _k2_e1_cases(dev)
    t0 = time.perf_counter()
    records.update(_api_cases(cfg, dev))
    launches = _api_phase(cfg, dev)
    print(f"api: phase {time.perf_counter() - t0:.1f}s", flush=True)
    _reference_phase(dev)
    _reference_archs(dev)
    serve_launches, engine = _serve_phase(dev)
    launches.update(serve_launches)
    by_path = {"serve": serve_launches, "session": _session_phase(engine),
               "generate_reference": _reference_full(engine)}
    olmoe = _prefill_olmoe(engine)
    by_path.update(_window_phase(engine))
    by_path["pipeline"] = _pipeline_phase(engine)
    shard_paths, folded = _dispatch_shards_phase(dev, engine)
    by_path.update(shard_paths)
    records["expert_quant_matmul"].append(folded)
    del engine
    arch_paths, archs = _serve_archs(dev)
    by_path.update(arch_paths)
    gates = olmoe["gates"] + archs["gates"]
    print("prefill_graph: " + json.dumps(dict(
        gates=gates, engines=[olmoe["engine"]] + archs["engines"])),
        flush=True)
    errors = [g["launch_error"] for g in gates if g["launch_error"]]
    assert not errors, errors
    frontend_paths, _ = _frontend_phase(dev)
    by_path.update(frontend_paths)
    by_path["train_serve"] = _train_phase(dev)
    by_path["expert_parallel"] = _expert_parallel_phase(dev)

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
