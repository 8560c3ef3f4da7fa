"""SDXL checkpoint key conversion: sgm/ComfyUI single-file layout <-> internal
(``vision_ft_tpu/models/sdxl/util.py`` counterpart, the same rules), so sgm
checkpoints load and ComfyUI LoRA exports match the JAX package's
key for key. Internal layout differences vs sgm:
UNet block lists gain a ``.blocks.`` segment; VAE uses diffusers-style
names; the two text encoders live under ``text_encoder.text_encoder_{1,2}``.
"""

from __future__ import annotations

import re


def unet_block_convert_from_original_key(key: str) -> str:
    key = re.sub(r"(input|output)_blocks\.", r"\1_blocks.blocks.", key)
    return key.replace("middle_block.", "middle_block.blocks.", 1)


def unet_block_convert_to_original_key(key: str) -> str:
    key = re.sub(r"(input|output)_blocks\.blocks\.", r"\1_blocks.", key)
    return key.replace("middle_block.blocks.", "middle_block.", 1)


def denoiser_convert_from_original_key(key: str) -> str:
    return unet_block_convert_from_original_key(key)


def denoiser_convert_to_original_key(key: str) -> str:
    return unet_block_convert_to_original_key(key)


_VAE_FROM_ORIGINAL = [
    (".attn_1.", ".attentions.0."),
    (".q.", ".to_q."),
    (".k.", ".to_k."),
    (".v.", ".to_v."),
    (".proj_out.", ".to_out.0."),
    (".norm.", ".group_norm."),
    (".nin_shortcut.", ".conv_shortcut."),
    (".mid.", ".mid_block."),
]


def vae_convert_from_original_key(key: str, num_blocks: int = 4) -> str:
    if ".mid." in key:
        key = re.sub(r"block_(\d+)", lambda m: f"resnets.{int(m.group(1)) - 1}", key)
    for src, dst in _VAE_FROM_ORIGINAL:
        key = key.replace(src, dst, 1)
    if m := re.search(r".*\.up\.(\d+)\..*", key):
        key = re.sub(r"\.up\.\d+\.", f".up_blocks.{num_blocks - 1 - int(m.group(1))}.", key)
    elif m := re.search(r".*\.down\.(\d+)\..*", key):
        key = re.sub(r"\.down\.\d+\.", f".down_blocks.{int(m.group(1))}.", key)
    key = key.replace(".upsample.conv.", ".upsamplers.0.conv.", 1)
    key = key.replace(".downsample.conv.", ".downsamplers.0.conv.", 1)
    key = key.replace(".block.", ".resnets.", 1)
    key = key.replace(".norm_out.", ".conv_norm_out.", 1)
    return key


def vae_convert_to_original_key(key: str, num_blocks: int = 4) -> str:
    if ".mid_block." in key:
        key = re.sub(r"resnets\.(\d+)", lambda m: f"block_{int(m.group(1)) + 1}", key)
    for dst, src in _VAE_FROM_ORIGINAL:
        key = key.replace(src, dst, 1)
    if m := re.search(r".*\.up_blocks\.(\d+)\..*", key):
        key = re.sub(r"\.up_blocks\.\d+\.", f".up.{num_blocks - 1 - int(m.group(1))}.", key)
    elif m := re.search(r".*\.down_blocks\.(\d+)\..*", key):
        key = re.sub(r"\.down_blocks\.\d+\.", f".down.{int(m.group(1))}.", key)
    key = key.replace(".upsamplers.0.conv.", ".upsample.conv.", 1)
    key = key.replace(".downsamplers.0.conv.", ".downsample.conv.", 1)
    key = key.replace(".resnets.", ".block.", 1)
    key = key.replace(".conv_norm_out.", ".norm_out.", 1)
    return key


def root_convert_from_original_key(key: str) -> str:
    key = key.replace("model.diffusion_model.", "diffusion_model.", 1)
    key = key.replace("diffusion_model.", "denoiser.", 1)
    key = key.replace(
        "conditioner.embedders.0.transformer.", "text_encoder.text_encoder_1.", 1
    )
    key = key.replace(
        "conditioner.embedders.1.model.text_projection",
        "text_encoder.text_encoder_2.text_projection.weight",
        1,
    )
    key = key.replace(
        "conditioner.embedders.1.model.", "text_encoder.text_encoder_2.text_model.", 1
    )
    return key.replace("first_stage_model.", "vae.", 1)


def root_convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", "model.diffusion_model.", 1)
    key = key.replace(
        "text_encoder.text_encoder_1.", "conditioner.embedders.0.transformer.", 1
    )
    key = key.replace(
        "text_encoder.text_encoder_2.text_projection.weight",
        "conditioner.embedders.1.model.text_projection",
        1,
    )
    key = key.replace(
        "text_encoder.text_encoder_2.text_model.", "conditioner.embedders.1.model.", 1
    )
    return key.replace("vae.", "first_stage_model.", 1)


def convert_from_original_key(key: str) -> str:
    key = root_convert_from_original_key(key)
    if key.startswith("denoiser."):
        key = denoiser_convert_from_original_key(key)
    elif key.startswith("vae."):
        key = vae_convert_from_original_key(key)
    return key


def convert_to_original_key(key: str) -> str:
    if key.startswith("denoiser."):
        key = denoiser_convert_to_original_key(key)
    elif key.startswith("vae."):
        key = vae_convert_to_original_key(key)
    return root_convert_to_original_key(key)


def convert_to_comfy_key(key: str) -> str:
    """Internal key -> ComfyUI LoRA export key (clip_l./clip_g./diffusion_model.)."""
    key = key.replace("text_encoder.text_encoder_1.", "clip_l.", 1)
    key = key.replace("text_encoder.text_encoder_2.", "clip_g.", 1)
    if key.startswith("denoiser."):
        key = denoiser_convert_to_original_key(key)
        key = key.replace("denoiser.", "diffusion_model.", 1)
    return key
