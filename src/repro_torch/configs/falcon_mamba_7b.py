"""Falcon-Mamba-7B: pure Mamba1, attention-free [arXiv:2410.05355].

DyMoE's router/attention-driven importance is inapplicable (no router, no
attention); only the depth-aware precision tiers apply (DESIGN.md
§Arch-applicability)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        arch_type="ssm",
        num_layers=64,
        d_model=4096,
        vocab_size=65024,
        ssm_version=1,
        d_inner=8192,
        ssm_state=16,
        ssm_conv=4,
        dt_rank=256,
        d_ff=0,
        pos_emb="none",
        dtype="bfloat16",
        max_seq_len=524288,
        source="mamba1 arch [arXiv:2410.05355]",
    )
