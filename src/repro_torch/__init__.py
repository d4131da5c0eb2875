"""PyTorch/CUDA port of the DyMoE reproduction (``src/repro`` is the JAX
reference it is held against). Imports torch and numpy only."""
