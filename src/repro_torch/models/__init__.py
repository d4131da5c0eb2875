"""Model substrate of the port: configs, KV cache, layers, and the
prefill / decode / training entry points (``repro_torch.models.model``)."""
from repro_torch.models.config import DyMoEPolicy, ModelConfig
from repro_torch.models.model import DyMoEInfo, decode_many, \
    decode_many_batched, decode_step, forward, init_decode_state, \
    init_params, loss_fn, prefill, quantize_model, train_step_fn

__all__ = ["ModelConfig", "DyMoEPolicy", "init_params", "quantize_model",
           "forward", "loss_fn", "train_step_fn", "prefill", "decode_step",
           "decode_many", "decode_many_batched", "init_decode_state",
           "DyMoEInfo"]
