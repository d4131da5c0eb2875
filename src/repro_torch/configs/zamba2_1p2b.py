"""Zamba2-1.2B: Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242]. ssm_state=64; shared transformer block every 6 layers.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        arch_type="hybrid",
        num_layers=38,
        d_model=2048,
        vocab_size=32000,
        ssm_version=2,
        d_inner=4096,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_conv=4,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        shared_attn_every=6,
        pos_emb="rope",
        dtype="bfloat16",
        max_seq_len=524288,
        source="Mamba2 + shared attn blocks [arXiv:2411.15242]",
    )
