"""Qwen1.5-MoE-A2.7B: 60 routed experts top-4 + 4 shared experts
[hf:Qwen/Qwen1.5-MoE-A2.7B]. QKV bias (Qwen1.5 family)."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        arch_type="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        moe_d_ff=1408,
        num_experts=60,
        num_experts_per_tok=4,
        num_shared_experts=4,
        vocab_size=151936,
        qkv_bias=True,
        pos_emb="rope",
        dtype="bfloat16",
        max_seq_len=32768,
        dymoe=DyMoEPolicy(high_bits=4, low_bits=2, retention=0.75),
        source="4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]",
    )
