"""Lumina2 checkpoint key converters (the port's own copy of
``vision_ft_tpu/models/lumina2/util.py``)."""

from __future__ import annotations

DENOISER_TENSOR_PREFIX = "model.diffusion_model."
TEXT_ENCODER_TENSOR_PREFIX = "text_encoders.gemma2_2b.transformer."
VAE_TENSOR_PREFIX = "vae."


def convert_from_original_key(key: str) -> str:
    key = key.replace("model.diffusion_model.", "diffusion_model.", 1)
    key = key.replace("diffusion_model.", "denoiser.", 1)
    key = key.replace(TEXT_ENCODER_TENSOR_PREFIX, "text_encoder.", 1)
    return key


def convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", DENOISER_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.", TEXT_ENCODER_TENSOR_PREFIX, 1)
    return key


def convert_to_comfy_key(key: str) -> str:
    key = key.replace("denoiser.", "diffusion_model.", 1)
    key = key.replace("text_encoder.", TEXT_ENCODER_TENSOR_PREFIX, 1)
    return key
