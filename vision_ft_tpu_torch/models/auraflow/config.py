"""AuraFlow config schemas, field for field the JAX package's
(``vision_ft_tpu/models/auraflow/config.py``), so one YAML config drives
both; ``AuraFlowConig`` keeps its typo for the same reason."""

from __future__ import annotations

from typing import Optional

from pydantic import BaseModel, ValidationInfo, field_validator


class DenoiserConfig(BaseModel):
    in_channels: int = 4
    out_channels: int = 4
    patch_size: int = 2
    caption_projection_dim: int = 3072
    num_double_layers: int = 4
    num_single_layers: int = 32
    num_attention_heads: int = 12
    attention_head_dim: int = 256
    joint_attention_dim: int = 2048
    pos_embed_max_size: int = 96 * 96  # 9216
    num_register_tokens: int = 8
    hidden_act: str = "silu"

    use_flash_attn: bool = True
    use_rope: bool = False
    rope_theta: int = 10000
    rope_dim_sizes: list[int] = [32, 112, 112]

    use_shortcut: bool = False
    use_guidance: bool = False

    @field_validator("rope_dim_sizes", mode="after")
    @classmethod
    def check_rope_dim_sizes(cls, v: list[int], info: ValidationInfo):
        if info.data.get("use_rope") is not True:
            return v
        if sum(v) != info.data["attention_head_dim"]:
            raise ValueError(
                "sum of rope_dim_sizes must be attention_head_dim: "
                f"{info.data['attention_head_dim']}"
            )
        return v


class AuraFlowConig(BaseModel):
    checkpoint_path: str
    pretrained_model_name_or_path: str = "fal/AuraFlow-v0.3"
    variant: Optional[str] = "fp16"

    vae_folder: str = "vae"
    text_encoder_folder: str = "text_encoder"
    tokenizer_folder: str = "tokenizer"
    denoiser_folder: str = "transformer"

    dtype: str = "bfloat16"

    denoiser: DenoiserConfig = DenoiserConfig()
