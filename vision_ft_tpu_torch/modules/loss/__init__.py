from . import diffusion

__all__ = ["diffusion"]
