"""Lumina2 config schemas (NextDiT 2B, grouped-query attention, patch 2,
adaLN, refiners), field for field the JAX package's
(``vision_ft_tpu/models/lumina2/config.py``), so one YAML config drives
both."""

from __future__ import annotations

from typing import Optional

from pydantic import BaseModel


class DenoiserConfig(BaseModel):
    in_channels: int = 16
    out_channels: int = 16

    hidden_dim: int = 2304
    caption_dim: int = 2304
    timestep_embed_dim: int = 256
    norm_eps: float = 1e-5

    depth: int = 26
    num_heads: int = 24
    num_kv_heads: int = 8
    refiner_depth: int = 2
    multiple_of: int = 256

    axes_dims: list[int] = [32, 32, 32]
    axes_lens: list[int] = [300, 512, 512]
    theta: int = 10_000
    qkv_bias: bool = True  # accepted for config parity; the qkv projection has no bias

    patch_size: int = 2
    vae_channels: int = 16


class Lumina2Config(BaseModel):
    checkpoint_path: str
    # dir or file with tokenizer assets (tokenizer.json / *.model / vocab.json)
    tokenizer_path: Optional[str] = None
    dtype: str = "bfloat16"
    denoiser: DenoiserConfig = DenoiserConfig()
