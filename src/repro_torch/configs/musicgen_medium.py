"""MusicGen-medium decoder over EnCodec tokens [arXiv:2306.05284].

[audio] — the mel/EnCodec conv frontend is STUBBED per the assignment
carve-out: ``input_specs`` feeds precomputed frame embeddings. The decoder
is a standard transformer (MHA kv=24, GELU FFN, sinusoidal positions)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        vocab_size=2048,
        mlp_type="gelu",
        pos_emb="sinusoidal",
        dtype="bfloat16",
        max_seq_len=32768,
        source="decoder-only over EnCodec tokens [arXiv:2306.05284]",
    )
