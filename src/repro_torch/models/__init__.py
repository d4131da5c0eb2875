"""Model substrate of the port: configs, KV cache, layers, and the
prefill / decode entry points (``repro_torch.models.model``)."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig

__all__ = ["ModelConfig", "DyMoEPolicy"]
