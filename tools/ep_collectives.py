#!/usr/bin/env python3
"""Time the collectives of a (1, 4) mesh of gloo ranks sharing one NVIDIA
GPU — what ``chip_smoke.py``'s ``expert_parallel:`` phase pays a decode
step — in a fresh process: ``Mesh.all_reduce`` SUM of float32 CUDA
tensors of 4 KiB and 2 MiB (the size of a decode step's expert gather at
full-width OLMoE-1B-7B), alone and after 50 small kernels (a decode
step's pattern: a burst of launches, then a collective), each through
gloo's CUDA path and staged through host memory by hand, with and
without the fingerprint check. Prints one JSON line a rank-0 case:
median ms a collective over 50 (the launch burst's own ms subtracted).

    python3 tools/ep_collectives.py      # from the repository root
"""
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
ITERS = 50


def _rank(rank, device, sizes):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_sim_mesh

    mesh = make_sim_mesh(4)
    out = []

    def burst(x):
        for _ in range(50):
            x.mul_(1.0)

    for n in sizes:
        t = torch.ones(n, dtype=torch.float32, device=device)
        x = torch.ones(2048, device=device)
        for staged in (False, True):
            for check in (True, False):
                mesh.check = check

                def coll():
                    if staged:
                        h = t.cpu()
                        mesh.all_reduce(h)
                        t.copy_(h)
                    else:
                        mesh.all_reduce(t)

                for with_burst in (False, True):
                    times, base = [], []
                    for i in range(ITERS + 5):
                        torch.cuda.synchronize()
                        dist.barrier()
                        t0 = time.perf_counter()
                        if with_burst:
                            burst(x)
                            torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        coll()
                        torch.cuda.synchronize()
                        t2 = time.perf_counter()
                        if i >= 5:
                            times.append(t2 - t1)
                            base.append(t1 - t0)
                    out.append(dict(
                        bytes=4 * n, staged=staged, check=check,
                        after_burst=with_burst,
                        ms=statistics.median(times) * 1e3,
                        p90_ms=sorted(times)[int(0.9 * ITERS)] * 1e3,
                        burst_ms=statistics.median(base) * 1e3))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ep_collectives: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.launch.mesh import spawn

    print(cs._smi(), flush=True)
    t0 = time.perf_counter()
    ranks = spawn(_rank, 4, [1024, 512 * 1024], device="cuda")
    for case in ranks[0]:
        print(json.dumps(case), flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
