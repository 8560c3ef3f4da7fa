"""FractalGen's modules (``vision_ft_tpu/models/fractal`` counterpart): the
masked transformer of one recursion level, its guiding-pixel transformer,
generation orders and masks. As in the JAX package these are modules only,
with no pipeline and no train entry."""

from .generator import (
    FractalMaskedTransformer,
    FractalMaskedTransformerOutput,
    FractalTransformerBlock,
)
from .mask import TruncatedNormalMaskGenerator, UniformMaskGenerator
from .order_sampler import sample_order
from .pixel import PixelHead, PixelTransformer, PixelTransformerOutput

__all__ = [
    "FractalMaskedTransformer",
    "FractalMaskedTransformerOutput",
    "FractalTransformerBlock",
    "UniformMaskGenerator",
    "TruncatedNormalMaskGenerator",
    "sample_order",
    "PixelHead",
    "PixelTransformer",
    "PixelTransformerOutput",
]
