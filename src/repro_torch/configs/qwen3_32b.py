"""Qwen3-32B: dense, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b",
        arch_type="dense",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        pos_emb="rope",
        rope_theta=1e6,
        dtype="bfloat16",
        max_seq_len=32768,
        source="qk_norm, GQA [hf:Qwen/Qwen3-8B]",
    )
