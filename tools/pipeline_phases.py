#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``pipeline:`` and ``dispatch_shards:`` phases
alone on one NVIDIA GPU, in a fresh process: build the kernels, load
full-width OLMoE-1B-7B ("4/2", seeded random weights) as the serve phase
does, serve its 8 requests twice (the graph keys), then the two phases.
A quicker A/B of the pipelined replay than the whole smoke run.

    python3 tools/pipeline_phases.py      # from the repository root
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pipeline_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.model import init_params
    from repro_torch.serving import DyMoEEngine, EngineConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs._smi(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cfg = get_config("olmoe_1b_7b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    engine = DyMoEEngine(cfg, params, EngineConfig(decode_chunk=16),
                         device=dev)
    for _ in range(2):
        engine.generate_batch(cs._serve_requests(cfg), num_slots=4)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - t0:.1f}s", flush=True)
    cs._pipeline_phase(engine)
    cs._dispatch_shards_phase(dev, engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
