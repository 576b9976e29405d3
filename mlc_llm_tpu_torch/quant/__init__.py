"""Group-wise weight-only quantization core (int4, int3, fp4 and int8)."""

from .spec import QuantSpec, QUANT_PRESETS, resolve_spec, spec_for_k
from .groupwise import (
    QuantizedTensor,
    quantize,
    dequantize,
    take_dequantize,
    pad_quantized_groups,
)

__all__ = [
    "QuantSpec",
    "QUANT_PRESETS",
    "resolve_spec",
    "spec_for_k",
    "QuantizedTensor",
    "quantize",
    "dequantize",
    "take_dequantize",
    "pad_quantized_groups",
]
