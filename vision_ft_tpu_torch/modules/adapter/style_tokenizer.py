"""Style tokenizer projectors (``vision_ft_tpu/modules/adapter/
style_tokenizer.py`` counterpart).

A frozen vision backbone's features become N ``<|style|>`` token
embeddings, scattered into the CLIP text towers' input embeddings at the
style-token positions (PFG concatenates to the context instead).
Projector shapes: linear (zero-initialized), MLP (hidden width
``in_features``, xavier), and the perceiver resampler with a
``style_query``, xavier transformer weights and a zero ``proj_out``.

The keys are the JAX package's; the checkpoint file holds them under
``projector_1.`` / ``projector_2.``
(``models/sdxl/adapter/style_tokenizer.py``).
"""

from __future__ import annotations

from typing import Literal, Optional

import torch
import torch.nn.functional as F
from pydantic import BaseModel
from torch import nn

from ...nn import Linear, init_parameters_
from .prompt_free import ResamplerImageProjector as _PFGResampler
from .prompt_free import xavier_normal_


class LinearImageProjector(nn.ModuleDict):
    """features (B, F) -> (B, N, out): one zero-initialized Linear."""

    def __init__(self, in_features: int, out_features: int = 768, num_style_tokens: int = 4):
        super().__init__({"projection": Linear(in_features, out_features * num_style_tokens)})
        self.out_features = out_features
        self.num_tokens = num_style_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        self["projection"].weight.zero_()
        self["projection"].bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        tokens = self["projection"](features)
        return tokens.reshape(-1, self.num_tokens, self.out_features)


class MLPImageProjector(nn.ModuleDict):
    """Linear -> SiLU -> Linear (hidden width ``in_features``), xavier
    weights, zero biases."""

    def __init__(self, in_features: int, out_features: int = 768, num_style_tokens: int = 4):
        super().__init__(
            {
                "mlp": nn.ModuleDict(
                    {
                        "0": Linear(in_features, in_features),
                        "2": Linear(in_features, out_features * num_style_tokens),
                    }
                )
            }
        )
        self.out_features = out_features
        self.num_tokens = num_style_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        for layer in self["mlp"].values():
            xavier_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        tokens = self["mlp"]["2"](F.silu(self["mlp"]["0"](features)))
        return tokens.reshape(-1, self.num_tokens, self.out_features)


class ResamplerImageProjector(_PFGResampler):
    """The PFG resampler with a ``style_query``, xavier transformer
    weights and a zero ``proj_out``."""

    query_key = "style_query"
    transformer_init = "xavier"
    proj_out_init = "zeros"

    def __init__(self, in_features: int, out_features: int = 768, num_style_tokens: int = 4,
                 num_layers: int = 1, num_heads: int = 8, mlp_ratio: float = 4.0,
                 attn_implementation: str = "xla"):
        super().__init__(in_features, out_features, num_style_tokens, num_layers=num_layers,
                         num_heads=num_heads, mlp_ratio=mlp_ratio,
                         attn_implementation=attn_implementation)


class StyleTokenizerConfig(BaseModel):
    style_token: str = "<|style|>"
    num_style_tokens: int = 4
    image_size: int = 512
    background_color: int = 0

    projector_type: Literal["linear", "mlp", "resampler"] = "mlp"
    projector_args: dict = {}

    checkpoint_weight: Optional[str] = None

    image_encoder: dict = {}  # AutoModelConfig fields (models/auto.py)
    image_mean: list[float] = [0.5, 0.5, 0.5]
    image_std: list[float] = [0.5, 0.5, 0.5]
    feature_dim: int = 768


class StyleTokenizerManager:
    def __init__(self, adapter_config: StyleTokenizerConfig):
        self.adapter_config = adapter_config

    def get_projector(self, out_features: int) -> nn.Module:
        cfg = self.adapter_config
        args = cfg.projector_args
        if cfg.projector_type == "linear":
            return LinearImageProjector(cfg.feature_dim, out_features, cfg.num_style_tokens)
        if cfg.projector_type == "mlp":
            return MLPImageProjector(cfg.feature_dim, out_features, cfg.num_style_tokens)
        if cfg.projector_type == "resampler":
            return ResamplerImageProjector(
                cfg.feature_dim, out_features, cfg.num_style_tokens,
                num_layers=args.get("num_layers", 1), num_heads=args.get("num_heads", 8),
                mlp_ratio=args.get("mlp_ratio", 4.0),
            )
        raise ValueError(f"Invalid projector type: {cfg.projector_type}")
