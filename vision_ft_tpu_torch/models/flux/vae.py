"""Flux VAE: the 16-channel KL autoencoder (``vision_ft_tpu/models/flux/
vae.py`` counterpart), the module Lumina2 uses. Flux's ``encode_image`` /
``decode_image`` skip its shift factor, as the JAX package does."""

from __future__ import annotations

from ..autoencoder import AutoencoderKL
from ..autoencoder.kl import FLUX_VAE_CONFIG

VAE_TENSOR_PREFIX = "vae."
DEFAULT_VAE_CONFIG = FLUX_VAE_CONFIG


class VAE(AutoencoderKL):
    compression_ratio = 8
    scaling_factor = 0.3611
    shift_factor = 0.1159
