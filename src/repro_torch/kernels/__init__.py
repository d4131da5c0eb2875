"""Hand-written GPU kernels of the port and their public entry points
(torch twin of ``repro.kernels``). A CUDA tensor launches the kernel, a
CPU tensor runs its plain PyTorch version; a kernel is built at its first
launch, never at import."""
from repro_torch.kernels.attn_scores.ops import flash_attention_with_scores
from repro_torch.kernels.quant_matmul.ops import expert_quant_matmul, \
    quant_matmul

__all__ = ["quant_matmul", "expert_quant_matmul",
           "flash_attention_with_scores"]
