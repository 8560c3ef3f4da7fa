"""Flux checkpoint key converters (the port's own copy of
``vision_ft_tpu/models/flux/util.py``): internal ``denoiser.`` / ``vae.`` /
``text_encoder.{clip,t5}.`` keys to and from the original single-file
layout (``model.diffusion_model.``, ``vae.``,
``text_encoders.{clip_l,t5xxl}.transformer.``) and ComfyUI's
(``diffusion_model.``)."""

from __future__ import annotations

from .denoiser import DENOISER_TENSOR_PREFIX
from .text_encoder import TEXT_ENCODER_CLIP_TENSOR_PREFIX, TEXT_ENCODER_T5_TENSOR_PREFIX
from .vae import VAE_TENSOR_PREFIX


def convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", DENOISER_TENSOR_PREFIX, 1)
    key = key.replace("vae.", VAE_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.clip.", TEXT_ENCODER_CLIP_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.t5.", TEXT_ENCODER_T5_TENSOR_PREFIX, 1)
    return key


def convert_to_comfy_key(key: str) -> str:
    key = key.replace("denoiser.", "diffusion_model.", 1)
    key = key.replace("vae.", VAE_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.clip.", TEXT_ENCODER_CLIP_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.t5.", TEXT_ENCODER_T5_TENSOR_PREFIX, 1)
    return key


def convert_from_original_key(key: str) -> str:
    if key.startswith("model.diffusion_model."):
        key = key.replace("model.diffusion_model.", "denoiser.", 1)
    elif key.startswith("diffusion_model."):
        key = key.replace("diffusion_model.", "denoiser.", 1)
    elif key.startswith(TEXT_ENCODER_CLIP_TENSOR_PREFIX):
        key = key.replace(TEXT_ENCODER_CLIP_TENSOR_PREFIX, "text_encoder.clip.", 1)
    elif key.startswith(TEXT_ENCODER_T5_TENSOR_PREFIX):
        key = key.replace(TEXT_ENCODER_T5_TENSOR_PREFIX, "text_encoder.t5.", 1)
    return key
