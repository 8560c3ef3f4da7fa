from .convert import load_flat_params
from .core import Conv2d, Embedding, GroupNorm, LayerNorm, Linear, init_parameters_

__all__ = [
    "Conv2d",
    "Embedding",
    "GroupNorm",
    "LayerNorm",
    "Linear",
    "init_parameters_",
    "load_flat_params",
]
