from .config import (
    DenoiserConfig,
    Flex1AlphaDenoiserConfig,
    Flux1DevDenoiserConfig,
    Flux1SchnellDenoiserConfig,
    FluxConfig,
)
from .denoiser import Denoiser, Flux
from .pipeline import FluxModel

__all__ = [
    "DenoiserConfig",
    "Flux1DevDenoiserConfig",
    "Flux1SchnellDenoiserConfig",
    "Flex1AlphaDenoiserConfig",
    "FluxConfig",
    "Denoiser",
    "Flux",
    "FluxModel",
]
