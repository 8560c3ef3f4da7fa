from .convert import load_flat_params, load_peft_state
from .core import (
    Conv2d,
    Embedding,
    GroupNorm,
    LayerNorm,
    Linear,
    init_parameters_,
    peft_enabled,
    remat_layer,
    save_name,
    set_peft_enabled,
    set_remat_saves,
)

__all__ = [
    "Conv2d",
    "Embedding",
    "GroupNorm",
    "LayerNorm",
    "Linear",
    "init_parameters_",
    "load_flat_params",
    "load_peft_state",
    "peft_enabled",
    "remat_layer",
    "save_name",
    "set_peft_enabled",
    "set_remat_saves",
]
