"""Port parity end to end: ``repro_torch``'s continuous-batching
``generate_batch`` gives the JAX engine's greedy tokens and modeled
TTFT/TPOT (exact) on ragged requests; the engine refuses to run without
CUDA unless asked for the CPU; and the port (its serving, replay and
sampling modules, the compiled programs, the multi-replica tier, the
launcher, ``chip_smoke``) imports with
``jax`` and ``repro`` made unimportable."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import numpy_init, port, port_cfg
from repro.models import init_params as jinit_params
from repro.models.config import DyMoEPolicy, ModelConfig
from repro.serving import DyMoEEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro_torch.serving import DyMoEEngine, EngineConfig, Request

ROOT = Path(__file__).resolve().parents[1]


def _cfg(low_bits):
    return ModelConfig(
        name="t", arch_type="moe", num_layers=3, d_model=64, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, num_experts=8,
        num_experts_per_tok=2, moe_d_ff=64, capacity_factor=4.0,
        dtype="float32", remat="none",
        dymoe=DyMoEPolicy(low_bits=low_bits, retention=0.75))


@pytest.mark.parametrize("low_bits", [2, 0], ids=["4/2", "4/0"])
def test_generate_batch_tokens_equal_jax_engine(low_bits):
    cfg = _cfg(low_bits)
    params = numpy_init(lambda: jinit_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (12, 9), (3, 12), (9, 4), (12, 6)]
    prompts = [[int(v) for v in rng.integers(1, cfg.vocab_size, s)]
               for s, _ in shapes]
    jout = JEngine(cfg, params, JEngineConfig(decode_chunk=4)).generate_batch(
        [JRequest(prompt_tokens=p, max_new_tokens=m)
         for p, (_, m) in zip(prompts, shapes)], num_slots=2)
    eng = DyMoEEngine(port_cfg(cfg), port(params), EngineConfig(
        decode_chunk=4), device="cpu")
    tout = eng.generate_batch([Request(prompt_tokens=p, max_new_tokens=m)
                               for p, (_, m) in zip(prompts, shapes)],
                              num_slots=2)
    assert [r.tokens for r in tout] == [r.tokens for r in jout]
    assert [len(r.tokens) for r in tout] == [m for _, m in shapes]
    assert eng.last_stats["waves_batched"] >= 1   # a ragged wave ran
    assert [(r.ttft_s, r.tpot_s) for r in tout] == \
        [(r.ttft_s, r.tpot_s) for r in jout]       # modeled: exact
    assert all(np.isfinite(r.ttft_s) and r.wall_s > 0 for r in tout)


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    cfg = _cfg(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DyMoEEngine(port_cfg(cfg), {})


def test_port_imports_without_jax_or_repro():
    # a None entry makes any import of the package raise ImportError
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.serving.engine\n"
            "import repro_torch.serving.scheduler\n"
            "import repro_torch.serving.faults\n"
            "import repro_torch.serving.policy\n"
            "import repro_torch.serving.request\n"
            "import repro_torch.serving.compiled\n"
            "import repro_torch.serving.cluster\n"
            "import repro_torch.launch.serve\n"
            "import repro_torch.launch.mesh\n"
            "import repro_torch.sharding.partition\n"
            "import repro_torch.sharding.spmd\n"
            "import repro_torch.serving.sampler\n"
            "import repro_torch.serving.cost_model\n"
            "import repro_torch.core.cache\n"
            "import repro_torch.core.orchestrator\n"
            "import repro_torch.params\n"
            "import repro_torch.kernels.quant_matmul.ops\n"
            "import chip_smoke\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
