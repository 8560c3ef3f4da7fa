"""AuraFlow checkpoint key converters (the port's own copy of
``vision_ft_tpu/models/auraflow/util.py``): internal ``denoiser.`` /
``vae.`` / ``text_encoder.model.`` keys to and from the original
single-file layout (``model.``, ``vae.``,
``text_encoders.pile_t5xl.transformer.``) and ComfyUI's
(``diffusion_model.``)."""

from __future__ import annotations

DENOISER_TENSOR_PREFIX = "model."
VAE_TENSOR_PREFIX = "vae."
TEXT_ENCODER_TENSOR_PREFIX = "text_encoders.pile_t5xl.transformer."


def convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", DENOISER_TENSOR_PREFIX, 1)
    key = key.replace("vae.", VAE_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.model.", TEXT_ENCODER_TENSOR_PREFIX, 1)
    return key


def convert_to_comfy_key(key: str) -> str:
    key = key.replace("denoiser.", "diffusion_model.", 1)
    key = key.replace("vae.", VAE_TENSOR_PREFIX, 1)
    key = key.replace("text_encoder.model.", TEXT_ENCODER_TENSOR_PREFIX, 1)
    return key


def convert_from_original_key(key: str) -> str:
    if key.startswith("diffusion_model."):
        key = key.replace("diffusion_model.", "denoiser.", 1)
    elif key.startswith(DENOISER_TENSOR_PREFIX):
        key = key.replace(DENOISER_TENSOR_PREFIX, "denoiser.", 1)
    elif key.startswith(TEXT_ENCODER_TENSOR_PREFIX):
        key = key.replace(TEXT_ENCODER_TENSOR_PREFIX, "text_encoder.model.", 1)
    # the vae. prefix is already the internal name
    return key
