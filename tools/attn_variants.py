#!/usr/bin/env python3
"""Build patched copies of the attention kernels K4 (``flash_fwd.cu``) and
K5 (``key_mass.cu``) and hold them side by side on one NVIDIA GPU: each
copy's worst error against the plain PyTorch versions, as
max |Δ| / (1 + |ref|) over out, lse and mass (the tolerance is 1e-4), and
its times.

Run from the repository root on a machine with the card:

    python3 tools/attn_variants.py products   # how many plane products
    python3 tools/attn_variants.py ablate     # where a kernel's time goes

``products`` drops products of the f32 score split (``score_tile.cuh``
``mma_step``): p6 is the kernels as they are; p5 drops mid.mid; p4 the
two lo products; p3 all three (two bf16 planes a value). ``ablate``
removes one part of the work each (its results are wrong by design):
the score MMAs, the P V step, the block's f32 plane split. Cases are
causal, H 16, D 128; "x c" scales q and k by sqrt(c), so the logits'
standard deviation is c. Times: ``ms`` is the CUDA-event time of 20
back-to-back launches per launch; ``dev_ms`` the kernels' device time
under torch.profiler. The copies build into
``build/attn_variants/<name>/`` (git-ignored)."""
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "attn_variants"

_LOHI = "mma_bf16(acc[j], af[2], bf[j][0].x, bf[j][0].y);"
_HILO = "mma_bf16(acc[j], af[0], bf[j][2].x, bf[j][2].y);"
_MIDMID = "mma_bf16(acc[j], af[1], bf[j][1].x, bf[j][1].y);"
# variant -> [(file in attn_scores/csrc, text, replacement)]
SETS = {
    "products": {
        "p6": [],
        "p5": [("score_tile.cuh", _MIDMID, ";")],
        "p4": [("score_tile.cuh", _LOHI, ";"), ("score_tile.cuh", _HILO, ";")],
        "p3": [("score_tile.cuh", _LOHI, ";"), ("score_tile.cuh", _HILO, ";"),
               ("score_tile.cuh", _MIDMID, ";")],
    },
    "ablate": {
        "as_built": [],
        "no_scores": [
            ("flash_fwd.cu",
             "score_tile<T, NB, KMAX>(s, sq, lda, kb, ldb, pst, ksteps);", ";"),
            ("flash_fwd.cu",
             "score_tile<1, NB, KMAX>(s, qf, kb, ldb, pst, ksteps);", ";"),
            ("key_mass.cu",
             "score_tile<planes<T>(), NB, KMAX>(s, kf, qb, ldb, pst, ksteps);",
             ";"),
            ("key_mass.cu",
             "score_tile<T, NB, KMAX>(s, sk, lda, qb, ldb, pst, ksteps);", ";")],
        "no_pv": [("flash_fwd.cu", "kk < NB / 2;", "kk < 0;")],
        "no_split": [
            ("flash_fwd.cu", "split_rows<3, CT>(tiles, pst, land, dp);", ""),
            ("flash_fwd.cu",
             "split_rows<2, CT>(tiles + 3 * pst, pst, land + CT * dp, dp);",
             ""),
            ("key_mass.cu", "split_rows<3, CT>(tiles, pst, land, dp);", "")],
    },
}
# (S, dtype name, logit standard deviation)
CASES = {
    "products": [(300, "float32", 11.0), (1024, "float32", 11.0),
                 (4096, "float32", 4.0), (4096, "float32", 1.0)],
    "ablate": [(4096, "float32", 1.0), (512, "bfloat16", 1.0),
               (512, "float32", 1.0), (4096, "bfloat16", 1.0)],
}


def _build(name, patches, nvcc, flags):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("attn_scores", "quant_matmul"):
        shutil.copytree(KERNELS / sub / "csrc", d / sub / "csrc")
    for f, old, new in patches:
        p = d / "attn_scores" / "csrc" / f
        text = p.read_text()
        assert old in text, (name, f, old)
        p.write_text(text.replace(old, new))
    procs = {src: subprocess.Popen(
        [nvcc, *flags, "-o", str(d / src.replace(".cu", ".so")),
         str(d / "attn_scores" / "csrc" / src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src in ("flash_fwd.cu", "key_mass.cu")}
    return d, procs


def main() -> int:
    if sys.argv[1:] not in (["products"], ["ablate"]):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("attn_variants: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build as kb
    from repro_torch.kernels.attn_scores import ref
    from torch.profiler import ProfilerActivity, profile

    which = sys.argv[1]
    nvcc = kb._nvcc()
    built = {n: _build(n, p, nvcc, kb.NVCC_FLAGS)
             for n, p in SETS[which].items()}
    libs = {}
    for n, (d, procs) in built.items():
        for src, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                print(log[-4000:], file=sys.stderr)
                return 1
        f4 = ctypes.CDLL(str(d / "flash_fwd.so")).flash_fwd_launch
        f5 = ctypes.CDLL(str(d / "key_mass.so")).key_mass_launch
        for f, lib in ((f4, "attn_flash_fwd"), (f5, "attn_key_mass")):
            f.argtypes, f.restype = kb.LIBS[lib].argtypes, ctypes.c_int
        libs[n] = (f4, f5)

    def event_ms(fn, reps=20, runs=7):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return sorted(times)[runs // 2]

    def dev_ms(fn, runs=5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   ) / runs / 1e3

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    h, d = 16, 128
    gen = torch.Generator(device="cuda").manual_seed(1)
    stream = torch.cuda.current_stream().cuda_stream
    for s, dt_name, sd in CASES[which]:
        dt = getattr(torch, dt_name)
        q, k, v = (torch.randn((h, s, d), generator=gen, device="cuda")
                   for _ in range(3))
        q, k, v = (q * sd ** 0.5).to(dt), (k * sd ** 0.5).to(dt), v.to(dt)
        rout, rlse = ref.flash_fwd_ref(q, k, v)
        rmass = ref.key_mass_ref(q, k, rlse)
        logit = (torch.einsum("qd,kd->qk", q[0].float(), k[0].float())
                 * d ** -0.5).abs().max().item()
        line = dict(case=f"causal H={h} S={s} D={d} {dt_name} x {sd}",
                    max_logit=round(logit, 1))
        for n, (f4, f5) in libs.items():
            out = torch.empty((h, s, d), device="cuda")
            lse = torch.empty((h, s), device="cuda")
            mass = torch.empty((h, s), device="cuda")
            bf = int(dt == torch.bfloat16)
            args4 = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bf,
                     out.data_ptr(), lse.data_ptr(), h, s, d, 1, d ** -0.5,
                     stream)
            args5 = (q.data_ptr(), k.data_ptr(), bf, lse.data_ptr(),
                     mass.data_ptr(), h, s, d, 1, d ** -0.5, stream)
            assert f4(*args4) == 0 and f5(*args5) == 0, n
            torch.cuda.synchronize()
            err = max(((a - b).abs() / (1 + b.abs())).max().item()
                      for a, b in ((out, rout), (lse, rlse), (mass, rmass)))
            line[n] = dict(err=err, k4_ms=event_ms(lambda: f4(*args4)),
                           k5_ms=event_ms(lambda: f5(*args5)),
                           k4_dev_ms=dev_ms(lambda: f4(*args4)),
                           k5_dev_ms=dev_ms(lambda: f5(*args5)))
        print(json.dumps(line), flush=True)
        del rout, rlse, rmass
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
