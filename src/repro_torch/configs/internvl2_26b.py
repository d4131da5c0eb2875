"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821].

[vlm] — the ViT (InternViT-6B) + MLP projector frontend is STUBBED per the
assignment carve-out: ``input_specs`` feeds precomputed patch/text embeddings
of shape (B, S, d_model) to the decoder.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        arch_type="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        mlp_type="swiglu",
        pos_emb="rope",
        rope_theta=1e6,
        dtype="bfloat16",
        max_seq_len=32768,
        source="InternViT + InternLM2 [arXiv:2404.16821]",
    )
