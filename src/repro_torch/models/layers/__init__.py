"""Model layers (functional, plain tensors)."""
