"""Packed mixed-precision weight storage (torch port of ``repro.quant``)."""
from repro_torch.quant.mixed import mixed_precision_matmul, \
    select_mixed_weights
from repro_torch.quant.packing import pack_bits, packed_dim, unpack_bits, \
    values_per_byte
from repro_torch.quant.qtensor import MixedPrecisionWeights, QuantizedTensor
from repro_torch.quant.quantize import dequantize_groupwise, \
    dequantize_tensor, gptq_lite_quantize, quantize_groupwise, \
    quantize_tensor

__all__ = ["pack_bits", "unpack_bits", "packed_dim", "values_per_byte",
           "quantize_groupwise", "dequantize_groupwise", "quantize_tensor",
           "dequantize_tensor", "gptq_lite_quantize", "QuantizedTensor",
           "MixedPrecisionWeights", "mixed_precision_matmul",
           "select_mixed_weights"]
