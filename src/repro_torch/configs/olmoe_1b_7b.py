"""OLMoE-1B-7B: 64 experts, top-8, fine-grained sparsity [arXiv:2409.02060].

Primary full-DyMoE target among the assigned archs (high-sparsity MoE, the
regime where the paper's Qwen3-30B-A3B results live).
"""
from repro_torch.models.config import DyMoEPolicy, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        moe_d_ff=1024,
        num_experts=64,
        num_experts_per_tok=8,
        vocab_size=50304,
        qk_norm=True,
        pos_emb="rope",
        dtype="bfloat16",
        max_seq_len=32768,
        # block_m=32: 64-expert top-8 dispatch leaves each expert's
        # capacity region a few rows deep — 128-row tiles would be mostly
        # padding; block_n=128 walks moe_d_ff=1024 in 8 tiles
        dymoe=DyMoEPolicy(high_bits=4, low_bits=2, retention=0.75,
                          block_m=32, block_n=128, block_k=512),
        source="64 experts top-8 [arXiv:2409.02060]",
    )
