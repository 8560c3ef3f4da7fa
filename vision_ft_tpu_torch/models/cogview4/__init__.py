from .config import CogView4Config, DenoiserConfig
from .denoiser import CogView4DiT, Denoiser
from .pipeline import CogView4Model, convert_from_original_key, convert_to_original_key

__all__ = [
    "CogView4Config",
    "DenoiserConfig",
    "CogView4DiT",
    "Denoiser",
    "CogView4Model",
    "convert_from_original_key",
    "convert_to_original_key",
]
