#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``train_mesh:`` run alone on one NVIDIA GPU, in
a fresh process: the CPU one-rank reference steps, then 4 gloo ranks
sharing the card, each running the train step under a mesh (the reduced
f32 cases on (1, 4), (2, 2) and (4, 1), with ZeRO-1 too on the last two,
and with the residual split along the sequence on (1, 4) and (2, 2), then
the full-width bf16 cases on (2, 2) with ZeRO-1, qwen3_0p6b's first step
also split), then the phase's gates and its ``train_mesh:`` line. No
kernel is built: training reaches none.

    python3 tools/train_mesh_phase.py      # from the repository root
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# also in the spawned ranks, which import this file again
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _rank(rank: int, device, fx) -> dict:
    import chip_smoke as cs
    t0 = time.perf_counter()
    run = cs._train_mesh_rank(rank, device, fx)
    return dict(rank=rank, train_mesh=dict(
        run, seconds=time.perf_counter() - t0))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.launch.mesh import spawn

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._smi(), flush=True)
    t0 = time.perf_counter()
    fx = cs._train_mesh_fixture()
    parent_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = spawn(_rank, cs.EP_RANKS, fx, device="cuda", timeout_s=300.0)
    ranks_s = time.perf_counter() - t0
    cs._train_mesh_gates(ranks, fx, dict(one_rank_s=parent_s,
                                         ranks_s=ranks_s))
    print(f"train_mesh: fixture {parent_s:.1f}s, ranks {ranks_s:.1f}s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
