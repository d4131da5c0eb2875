"""Qwen1.5-32B: dense MHA-heavy GQA kv=40 (i.e. MHA), QKV bias
[hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        arch_type="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=40,
        head_dim=128,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        pos_emb="rope",
        dtype="bfloat16",
        max_seq_len=32768,
        source="QKV bias [hf:Qwen/Qwen1.5-0.5B]",
    )
