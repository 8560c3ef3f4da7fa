from .config import DenoiserConfig, Wan22TI2V5BDenoiserConfig, WanConfig
from .denoiser import Denoiser, DiT
from .pipeline import Wan22
from .scheduler import Scheduler

__all__ = [
    "DenoiserConfig",
    "Wan22TI2V5BDenoiserConfig",
    "WanConfig",
    "Denoiser",
    "DiT",
    "Wan22",
    "Scheduler",
]
