"""Mixtral-8x7B — the paper's coarse-grained (low-sparsity) evaluation model
[arXiv:2401.04088]. 8 experts top-2, expert d_ff 14336."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        moe_d_ff=14336,
        num_experts=8,
        num_experts_per_tok=2,
        vocab_size=32000,
        pos_emb="rope",
        rope_theta=1e6,
        dtype="bfloat16",
        max_seq_len=32768,
        dymoe=DyMoEPolicy(high_bits=4, low_bits=2, retention=0.75),
        source="paper eval model [arXiv:2401.04088]",
    )
