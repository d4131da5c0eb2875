"""Attention with per-key received mass (DyMoE Eq. 1): hand-written CUDA
kernels for Hopper (``csrc/``) beside their plain PyTorch versions
(``ref.py``)."""
