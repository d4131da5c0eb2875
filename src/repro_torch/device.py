"""Where the port's tensors go when the caller names no device.

``None`` means CUDA: a public function of the port runs on the card unless
its caller asks for the CPU by name, and it never quietly falls back from
one to the other.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "on_cuda"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA without it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU unless "
                "the caller passes device='cpu' explicitly")
        # true f32 for f32 work on the card (parity with the reference)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(x: torch.Tensor) -> bool:
    """How a kernel entry point dispatches: True for a CUDA tensor (launch
    the kernel), False for a CPU tensor (run its plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")
