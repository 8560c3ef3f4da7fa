from .config import AuraFlowConig, DenoiserConfig
from .denoiser import Denoiser, MMDiT
from .pipeline import AuraFlowModel
from .scheduler import Scheduler

__all__ = [
    "AuraFlowConig",
    "DenoiserConfig",
    "Denoiser",
    "MMDiT",
    "AuraFlowModel",
    "Scheduler",
]
