"""Flux / Flex config schemas, field for field the JAX package's
(``vision_ft_tpu/models/flux/config.py``), so one YAML config drives both.
Each variant pins what it must be by a ``Literal``: flux1-dev embeds the
distilled guidance and shifts the timestep, flux1-schnell does neither,
flex1-alpha (8 double blocks) embeds guidance without the shift."""

from __future__ import annotations

from typing import Literal, Union

from pydantic import BaseModel


class DenoiserConfig(BaseModel):
    type: str

    in_channels: int = 64
    out_channels: int = 64
    vec_in_dim: int = 768
    context_in_dim: int = 4096
    hidden_size: int = 3072
    mlp_ratio: float = 4.0
    num_heads: int = 24
    depth: int = 19
    depth_single_blocks: int = 38
    axes_dim: list[int] = [16, 56, 56]
    theta: int = 10_000
    qkv_bias: bool = True

    patch_size: int = 2
    vae_channels: int = 16

    guidance_embed: bool = True
    do_timestep_shift: bool = True
    use_flash_attention: bool = False


class Flux1DevDenoiserConfig(DenoiserConfig):
    type: Literal["flux1-dev"] = "flux1-dev"
    guidance_embed: Literal[True] = True
    do_timestep_shift: Literal[True] = True


class Flux1SchnellDenoiserConfig(DenoiserConfig):
    type: Literal["flux1-schnell"] = "flux1-schnell"
    guidance_embed: Literal[False] = False
    do_timestep_shift: Literal[False] = False


class Flex1AlphaDenoiserConfig(DenoiserConfig):
    type: Literal["flex1-alpha"] = "flex1-alpha"
    depth: int = 8
    depth_single_blocks: int = 38
    guidance_embed: Literal[True] = True
    do_timestep_shift: Literal[False] = False


class FluxConfig(BaseModel):
    checkpoint_path: str
    dtype: str = "bfloat16"
    denoiser: Union[
        Flux1DevDenoiserConfig, Flux1SchnellDenoiserConfig, Flex1AlphaDenoiserConfig
    ] = Flex1AlphaDenoiserConfig()
