#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``expert_parallel:`` phase alone on one NVIDIA
GPU, in a fresh process: build the kernels, then the phase (4 gloo ranks
sharing the card, against one-rank runs of the same weights). A quicker
check of expert-parallel serving than the whole smoke run.

    python3 tools/ep_phase.py      # from the repository root
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ep_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._smi(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    launches = cs._expert_parallel_phase(torch.device("cuda"))
    print(f"launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
