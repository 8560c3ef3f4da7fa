"""Wan 2.2 config schemas, field for field the JAX package's
(``vision_ft_tpu/models/wan/config.py``), so one YAML config drives both."""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import BaseModel


class DenoiserConfig(BaseModel):
    type: Literal["ti2v", "t2v", "i2v"] = "ti2v"

    in_channels: int = 48
    out_channels: int = 48

    hidden_dim: int = 3072
    ffn_dim: int = 14336
    freq_dim: int = 256
    text_dim: int = 4096

    num_heads: int = 24
    num_layers: int = 30

    text_length: int = 512

    norm_eps: float = 1e-6

    axes_dims: tuple[int, int, int] = (16, 56, 56)
    theta: int = 10_000

    patch_size: tuple[int, int, int] = (1, 2, 2)
    vae_channels: int = 48


class Wan22TI2V5BDenoiserConfig(DenoiserConfig):
    type: Literal["ti2v"] = "ti2v"
    variant: Literal["2.2-ti2v-5b"] = "2.2-ti2v-5b"


class WanConfig(BaseModel):
    denoiser_path: str
    tokenizer_path: Optional[str] = None
    text_encoder_path: str
    vae_path: str

    dtype: str = "bfloat16"

    # annotated as the base class so tiny test and debug denoisers validate
    # too; the default stays the 2.2-TI2V-5B layout
    denoiser: DenoiserConfig = Wan22TI2V5BDenoiserConfig()
