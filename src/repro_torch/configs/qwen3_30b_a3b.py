"""Qwen3-30B-A3B — the paper's fine-grained (high-sparsity) evaluation model
[arXiv:2505.09388]. 128 experts top-8, expert d_ff 768."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-30b-a3b",
        arch_type="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,
        moe_d_ff=768,
        num_experts=128,
        num_experts_per_tok=8,
        vocab_size=151936,
        qk_norm=True,
        pos_emb="rope",
        rope_theta=1e6,
        dtype="bfloat16",
        max_seq_len=32768,
        dymoe=DyMoEPolicy(high_bits=4, low_bits=2, retention=0.75),
        source="paper eval model [arXiv:2505.09388]",
    )
