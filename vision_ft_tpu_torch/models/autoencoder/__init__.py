from .kl import AutoencoderKL, AutoencoderKLConfig

__all__ = ["AutoencoderKL", "AutoencoderKLConfig"]
