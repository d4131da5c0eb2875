"""Phi-3-medium-14B: dense, RoPE + SwiGLU + GQA kv=10 [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        arch_type="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=10,
        head_dim=128,
        d_ff=17920,
        vocab_size=100352,
        pos_emb="rope",
        dtype="bfloat16",
        max_seq_len=32768,
        source="RoPE SwiGLU GQA [arXiv:2404.14219]",
    )
