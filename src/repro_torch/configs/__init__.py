"""Architecture config registry.

Ten assigned architectures (public-literature pool) + the paper's own two
evaluation models. ``get_config(name)`` returns the exact full-size config;
``get_config(name).reduced()`` is the CPU smoke variant.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "internvl2_26b",
    "olmoe_1b_7b",
    "zamba2_1p2b",
    "qwen2_moe_a2p7b",
    "qwen3_32b",
    "falcon_mamba_7b",
    "phi3_medium_14b",
    "qwen3_0p6b",
    "musicgen_medium",
    "qwen1p5_32b",
    # paper's own evaluation models
    "mixtral_8x7b",
    "qwen3_30b_a3b",
]

# Edge-deployment subset the linter's ``--smoke`` run lints: the two
# small MoE configs plus the tiniest dense config — the fastest set that
# still exercises every rule family.
ANALYSIS_SMOKE_CONFIGS: List[str] = [
    "qwen3_0p6b",
    "olmoe_1b_7b",
    "qwen2_moe_a2p7b",
]

_ALIASES: Dict[str, str] = {
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "qwen3-32b": "qwen3_32b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-0.6b": "qwen3_0p6b",
    "musicgen-medium": "musicgen_medium",
    "qwen1.5-32b": "qwen1p5_32b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}


def get_config(name: str) -> ModelConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_IDS}


__all__ = ["ARCH_IDS", "ANALYSIS_SMOKE_CONFIGS", "get_config",
           "all_configs", "ModelConfig"]
