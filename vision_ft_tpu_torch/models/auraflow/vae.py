"""AuraFlow VAE: the SDXL KL autoencoder (4-channel latents, scaling
0.13025), ``vision_ft_tpu/models/auraflow/vae.py`` counterpart. The
pipeline builds ``AutoencoderKL(DEFAULT_VAE_CONFIG)``."""

from __future__ import annotations

from typing import Any

from ..autoencoder.kl import SDXL_VAE_CONFIG

VAE_TENSOR_PREFIX = "vae."
AURA_VAE_COMPRESSION_RATIO = SDXL_VAE_CONFIG.compression_ratio
AURA_VAE_SCALING_FACTOR = SDXL_VAE_CONFIG.scaling_factor

DEFAULT_VAE_CONFIG = SDXL_VAE_CONFIG


def detect_vae_type(state_dict: dict[str, Any]) -> str:
    """"original" (sgm naming) or "autoencoder_kl" (diffusers naming)."""
    if "vae.encoder.norm_out.weight" in state_dict:
        return "original"
    if "vae.encoder.conv_norm_out.weight" in state_dict:
        return "autoencoder_kl"
    raise ValueError("Unknown VAE type")
