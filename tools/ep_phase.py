#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``expert_parallel:`` phase alone on one NVIDIA
GPU, in a fresh process: build the kernels, then the phase (4 gloo ranks
sharing the card, against one-rank runs of the same weights: the (1, 4)
mesh, then the ``data_axis:`` run over (2, 2), then the ``ssm_mesh:``
run of the Mamba archs on both, then the ``train_mesh:`` run of the train
step). A quicker check of sharded serving than the whole smoke run;
``tools/train_mesh_phase.py`` runs the ``train_mesh:`` run alone.

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
    t0 = time.perf_counter()
    ep, data_axis, ssm_mesh, ssm_s, train_s = cs._expert_parallel_phase(
        torch.device("cuda"))
    print(f"launches expert_parallel {ep} data_axis {data_axis} ssm_mesh "
          f"{ssm_mesh}; phase {time.perf_counter() - t0:.1f}s, ssm_mesh "
          f"{ssm_s}, train_mesh {train_s}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
