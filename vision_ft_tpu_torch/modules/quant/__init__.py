from .functional import (
    QUANT_TYPE,
    collect_children_dict,
    convert_prequantized_state_dict,
    dequantize_weight,
    get_quant_type_from_children_dict,
    is_quantized_weight,
    quantize_inplace,
    quantize_params,
    quantize_state_dict,
    quantize_weight,
    replace_to_quant_linear,
    validate_quant_type,
)
from .nf4 import NF4_CODE, dequantize_4bit, quantize_4bit

# API-compat alias, as in the JAX package: the step is a pure state-dict
# conversion.
replace_by_prequantized_weights = convert_prequantized_state_dict

__all__ = [
    "QUANT_TYPE",
    "collect_children_dict",
    "convert_prequantized_state_dict",
    "replace_by_prequantized_weights",
    "dequantize_weight",
    "get_quant_type_from_children_dict",
    "is_quantized_weight",
    "quantize_inplace",
    "quantize_params",
    "quantize_state_dict",
    "quantize_weight",
    "validate_quant_type",
    "NF4_CODE",
    "dequantize_4bit",
    "quantize_4bit",
]
