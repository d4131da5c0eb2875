"""Qwen3-0.6B: dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        arch_type="dense",
        num_layers=28,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        pos_emb="rope",
        rope_theta=1e6,
        dtype="bfloat16",
        max_seq_len=32768,
        # edge-sized dm/dff: decode matmuls are a handful of rows against
        # d_ff=3072, so 128-row tiles would be >75% zero padding
        dymoe=DyMoEPolicy(block_m=32, block_n=256, block_k=512),
        source="qk_norm, GQA [hf:Qwen/Qwen3-8B]",
    )
