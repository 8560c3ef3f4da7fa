"""SDXL config schemas, field for field the JAX package's
(``vision_ft_tpu/models/sdxl/config.py``), so one YAML config drives both."""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import BaseModel

from ...ops.attention import AttentionImplementation

DOWN_BLOCK_NAME = Literal["DownBlock2D", "TransformerDownBlock2D"]
MID_BLOCK_NAME = Literal["TransformerMidBlock2D"]
UP_BLOCK_NAME = Literal["UpBlock2D", "TransformerUpBlock2D"]


class DenoiserConfig(BaseModel):
    in_channels: int = 4
    out_channels: int = 4

    hidden_dim: int = 320
    channel_multipiler: list[int] = [1, 2, 4]
    conv_resample: bool = True
    num_head_channels: int = 64
    context_dim: int = 2048
    global_cond_dim: int = 2816  # CLIP pooled (1280) + 6 * 256 size Fourier
    additional_condition_dim: int = 256

    block_out_channels: list[int] = [320, 640, 1280]
    num_transformers_per_block: list[int] = [1, 2, 10]
    layers_per_block: int = 2

    down_blocks: list[DOWN_BLOCK_NAME] = [
        "DownBlock2D",
        "TransformerDownBlock2D",
        "TransformerDownBlock2D",
    ]
    mid_block: MID_BLOCK_NAME = "TransformerMidBlock2D"
    up_blocks: list[UP_BLOCK_NAME] = [
        "TransformerUpBlock2D",
        "TransformerUpBlock2D",
        "UpBlock2D",
    ]

    # "flash" sends the large self-attentions of CUDA tensors through the
    # BSHD flash kernel (ops/attention.py)
    attention_backend: AttentionImplementation = "flash"
    vae_compression_ratio: float = 8.0


class SDXLConfig(BaseModel):
    checkpoint_path: str
    # dir with vocab.json + merges.txt for the CLIP BPE tokenizer
    tokenizer_path: Optional[str] = None

    pretrained_model_name_or_path: str = "stabilityai/stable-diffusion-xl-base-1.0"

    dtype: str = "bfloat16"

    denoiser: DenoiserConfig = DenoiserConfig()
