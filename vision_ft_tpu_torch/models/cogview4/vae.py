"""CogView4 VAE (``vision_ft_tpu/models/cogview4/vae.py`` counterpart): the
16-channel KL autoencoder with wider blocks (128, 512, 1024, 1024), three
layers a block, no quant convs and no mid-block attention; scaling 1.0,
shift 0.0."""

from __future__ import annotations

from ..autoencoder import AutoencoderKL
from ..autoencoder.kl import AutoencoderKLConfig

VAE_TENSOR_PREFIX = "vae."

DEFAULT_VAE_CONFIG = AutoencoderKLConfig(
    latent_channels=16,
    block_out_channels=(128, 512, 1024, 1024),
    layers_per_block=3,
    scaling_factor=1.0,
    shift_factor=0.0,
    use_quant_conv=False,
    mid_block_add_attention=False,
)


class VAE(AutoencoderKL):
    compression_ratio = 8
    scaling_factor = 1.0
    shift_factor = 0.0
