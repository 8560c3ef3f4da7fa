"""IP-Adapter: image-prompt conditioning (``vision_ft_tpu/modules/
adapter/ip_adapter/__init__.py`` counterpart): the config with its
projector and variant names, and the manager with the cross-attention-only
odd on-disk indexing and the projector factory."""

from __future__ import annotations

from typing import Literal, Optional

from pydantic import BaseModel

from ...peft import PeftConfigUnion
from ..util import Adapter, AdapterManager
from .projectors import (
    ImageTextProjector,
    LinearImageProjector,
    MLPImageProjector,
    ResamplerProjector,
    detect_projector_type,
    load_projector_from_state_dict,
)

PROJECTOR_TYPE = Literal["linear", "mlp", "resampler", "image_text"]

IP_ADAPTER_VARIANT = Literal[
    "original", "peft", "adaln_zero", "tanh_gate", "gate", "flamingo", "time_gate"
]


class AutoModelConfig(BaseModel):
    """The image encoder's backbone. The SigLIP named by default runs as
    the port's own ``models/vision_encoders/siglip.py``; the fields are
    the JAX package's, so one YAML drives both."""

    type: str = "timm"
    model_name: str = "hf_hub:timm/vit_base_patch16_siglip_384.v2_webli"
    pretrained: bool = True
    feature_type: Literal["hidden_state", "pooler_output"] = "hidden_state"
    hidden_state_index: int = -2


class TimmModelConfig(AutoModelConfig):
    type: str = "timm"


class TransformersModelConfig(AutoModelConfig):
    type: str = "transformers"


class IPAdapterConfig(BaseModel):
    ip_scale: float = 1.0
    num_ip_tokens: int = 4
    image_size: int = 384
    background_color: int = 0

    projector_type: PROJECTOR_TYPE = "mlp"
    projector_args: dict = {}
    dtype: str = "bfloat16"

    checkpoint_weight: Optional[str] = None

    image_encoder: AutoModelConfig = TimmModelConfig()
    image_mean: list[float] = [0.5, 0.5, 0.5]
    image_std: list[float] = [0.5, 0.5, 0.5]
    color_channel: Literal["rgb", "bgr"] = "rgb"
    feature_dim: int = 768

    variant: IP_ADAPTER_VARIANT = "original"

    peft: Optional[PeftConfigUnion] = None

    skip_zero_tokens: bool = False
    attn_renorm: bool = False


class IPAdapterManager(AdapterManager):
    adapter_config: IPAdapterConfig

    def get_projector(self, attention_dim: int):
        cfg = self.adapter_config
        args = cfg.projector_args
        if cfg.projector_type == "linear":
            return LinearImageProjector(
                in_features=cfg.feature_dim,
                cross_attention_dim=attention_dim,
                num_ip_tokens=cfg.num_ip_tokens,
            )
        if cfg.projector_type == "mlp":
            return MLPImageProjector(
                in_features=cfg.feature_dim,
                mlp_ratio=args.get("mlp_ratio", 1.0),
                cross_attention_dim=attention_dim,
                num_style_tokens=cfg.num_ip_tokens,
            )
        if cfg.projector_type == "resampler":
            return ResamplerProjector(
                in_features=cfg.feature_dim,
                num_heads=args.get("num_heads", 8),
                mlp_ratio=args.get("mlp_ratio", 4.0),
                cross_attention_dim=attention_dim,
                num_ip_tokens=cfg.num_ip_tokens,
                depth=args.get("depth", 4),
                normalization=args.get("normalization", "layernorm"),
                qk_norm=args.get("qk_norm", False),
            )
        if cfg.projector_type == "image_text":
            # text_dim defaults to SDXL's context width, hidden_dim is the
            # cross-attention width
            return ImageTextProjector(
                image_dim=cfg.feature_dim,
                text_dim=args.get("text_dim", 2048),
                hidden_dim=attention_dim,
                num_heads=args.get("num_heads", 8),
                num_blocks=args.get("depth", 4),
                mlp_ratio=args.get("mlp_ratio", 4.0),
                num_ip_tokens=cfg.num_ip_tokens,
            )
        raise NotImplementedError(f"Projector type {cfg.projector_type} not implemented.")


__all__ = [
    "Adapter",
    "AutoModelConfig",
    "TimmModelConfig",
    "TransformersModelConfig",
    "IPAdapterConfig",
    "IPAdapterManager",
    "IP_ADAPTER_VARIANT",
    "PROJECTOR_TYPE",
    "ImageTextProjector",
    "LinearImageProjector",
    "MLPImageProjector",
    "ResamplerProjector",
    "detect_projector_type",
    "load_projector_from_state_dict",
]
