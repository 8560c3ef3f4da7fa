"""Wan checkpoint key converters (``vision_ft_tpu/models/wan/util.py``
counterpart). Wan ships three safetensors files (denoiser, text encoder,
VAE); the text encoder gains a ``model.`` prefix inside the pipeline, the
denoiser drops the one it has on disk."""

from __future__ import annotations

from typing import Literal

Part = Literal["text_encoder", "denoiser", "vae"]


def text_encoder_convert_from_original_key(key: str) -> str:
    return key if key.startswith("model.") else f"model.{key}"


def text_encoder_convert_to_original_key(key: str) -> str:
    return key[6:] if key.startswith("model.") else key


def denoiser_convert_from_original_key(key: str) -> str:
    return key[6:] if key.startswith("model.") else key


def denoiser_convert_to_original_key(key: str) -> str:
    return key if key.startswith("model.") else f"model.{key}"


def peft_convert_from_original_key(key: str) -> str:
    """An adapter key in the denoiser file's names as ``Wan22.as_module()``
    names it."""
    return f"denoiser.{denoiser_convert_from_original_key(key)}"


def vae_convert_from_original_key(key: str) -> str:
    return key


def vae_convert_to_original_key(key: str) -> str:
    return key


def convert_from_original_key(key: str, module: Part) -> str:
    return {
        "text_encoder": text_encoder_convert_from_original_key,
        "denoiser": denoiser_convert_from_original_key,
        "vae": vae_convert_from_original_key,
    }[module](key)


def convert_to_original_key(key: str, module: Part) -> str:
    return {
        "text_encoder": text_encoder_convert_to_original_key,
        "denoiser": denoiser_convert_to_original_key,
        "vae": vae_convert_to_original_key,
    }[module](key)
