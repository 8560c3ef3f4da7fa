"""Lumina2 VAE: the 16-channel Flux KL autoencoder (scaling 0.3611, shift
0.1159, no quant convs); ``vision_ft_tpu/models/lumina2/vae.py``
counterpart. The pipeline builds ``AutoencoderKL(DEFAULT_VAE_CONFIG)``."""

from __future__ import annotations

from ..autoencoder.kl import FLUX_VAE_CONFIG

VAE_TENSOR_PREFIX = "vae."
FLUX_VAE_COMPRESSION_RATIO = FLUX_VAE_CONFIG.compression_ratio
FLUX_VAE_SCALING_FACTOR = FLUX_VAE_CONFIG.scaling_factor
FLUX_VAE_SHIFT_FACTOR = FLUX_VAE_CONFIG.shift_factor

DEFAULT_VAE_CONFIG = FLUX_VAE_CONFIG
