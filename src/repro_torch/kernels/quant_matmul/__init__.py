"""Packed mixed-precision expert matmuls: hand-written CUDA kernels for
Hopper (``csrc/``) beside their plain PyTorch versions (``ref.py``)."""
