"""Prompt-Free Generation (PFG) projectors (``vision_ft_tpu/modules/
adapter/prompt_free.py`` counterpart).

A frozen vision backbone's features are projected into N pseudo text
tokens that are concatenated to the (possibly empty) prompt context along
the sequence axis; the UNet is untouched. Three projector shapes: linear,
MLP (ratio 4), and a perceiver resampler whose learned query
cross-attends to the projected features (kv = [features; query]).

State-dict keys are the JAX package's (``projection.*``, ``mlp.{0,2}.*``,
``image_query``, ``proj_in.*``, ``transformer.N.{to_q,...,mlp.0,mlp.2}.*``,
``proj_out.*``). ``init_weights(generator)`` draws the JAX package's
initial distributions on the projector's device, in its dtype.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch
import torch.nn.functional as F
from pydantic import BaseModel
from torch import nn

from ...nn import LayerNorm, Linear, init_parameters_
from ...ops.attention import scaled_dot_product_attention


@torch.no_grad()
def xavier_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = weight.shape
    weight.normal_(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, generator=generator)


class LinearImageProjector(nn.ModuleDict):
    """features (B, F) -> (B, N, out): one Linear, xavier weight, zero bias."""

    def __init__(self, in_features: int, out_features: int = 768, num_image_tokens: int = 4):
        super().__init__({"projection": Linear(in_features, out_features * num_image_tokens)})
        self.out_features = out_features
        self.num_tokens = num_image_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        xavier_normal_(self["projection"].weight, generator)
        self["projection"].bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        tokens = self["projection"](features)
        return tokens.reshape(-1, self.num_tokens, self.out_features)


class MLPImageProjector(nn.ModuleDict):
    """Linear -> SiLU -> Linear (hidden ``in_features * mlp_ratio``),
    xavier weights, zero biases."""

    def __init__(self, in_features: int, out_features: int = 768, num_image_tokens: int = 4,
                 mlp_ratio: float = 4.0):
        inner = int(in_features * mlp_ratio)
        super().__init__(
            {
                "mlp": nn.ModuleDict(
                    {
                        "0": Linear(in_features, inner),
                        "2": Linear(inner, out_features * num_image_tokens),
                    }
                )
            }
        )
        self.out_features = out_features
        self.num_tokens = num_image_tokens

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        for layer in self["mlp"].values():
            xavier_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        tokens = self["mlp"]["2"](F.silu(self["mlp"]["0"](features)))
        return tokens.reshape(-1, self.num_tokens, self.out_features)


class PerceiverTransformer(nn.ModuleDict):
    """The query cross-attends to kv = [features; query] (affine-free
    pre-norms, bias-free q/k/v), then a SiLU MLP; both residual. The
    attention has a few hundred keys at most and takes the plain formula,
    as the JAX package's "xla" backend does."""

    def __init__(self, in_features: int, num_heads: int, mlp_ratio: float = 4.0,
                 attention_backend: str = "xla"):
        inner = int(in_features * mlp_ratio)
        super().__init__(
            {
                "norm_in_1": LayerNorm(in_features, eps=1e-6, elementwise_affine=False),
                "norm_in_2": LayerNorm(in_features, eps=1e-6, elementwise_affine=False),
                "to_q": Linear(in_features, in_features, bias=False),
                "to_k": Linear(in_features, in_features, bias=False),
                "to_v": Linear(in_features, in_features, bias=False),
                "to_out": Linear(in_features, in_features),
                "norm_out": LayerNorm(in_features, eps=1e-6, elementwise_affine=False),
                "mlp": nn.ModuleDict(
                    {"0": Linear(in_features, inner), "2": Linear(inner, in_features)}
                ),
            }
        )
        self.num_heads = num_heads
        self.backend = attention_backend

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        b, s, d = t.shape
        return t.reshape(b, s, self.num_heads, d // self.num_heads).transpose(1, 2)

    def _attention(self, query_tokens, hidden_states):
        q_in = self["norm_in_1"](query_tokens)
        h_in = self["norm_in_2"](hidden_states)
        kv_input = torch.cat([h_in, q_in], dim=1)
        q = self._heads(self["to_q"](q_in))
        k = self._heads(self["to_k"](kv_input))
        v = self._heads(self["to_v"](kv_input))
        attn = scaled_dot_product_attention(q, k, v, backend=self.backend)
        b, h, s, d = attn.shape
        attn = self["to_out"](attn.transpose(1, 2).reshape(b, s, h * d))
        return self["norm_out"](attn)

    def forward(self, query_tokens, hidden_states):
        query_tokens = self._attention(query_tokens, hidden_states) + query_tokens
        h = self["mlp"]["2"](F.silu(self["mlp"]["0"](query_tokens)))
        return h + query_tokens


class ResamplerImageProjector(nn.Module):
    """A learned query (``query_key``) through ``num_layers`` perceiver
    blocks over the projected features, then ``proj_out`` and an affine-free
    LayerNorm. The style variant reuses it with its own query key and
    initial distributions (``transformer_init``, ``proj_out_init``)."""

    query_key = "image_query"
    # "normal002": N(0, 0.02) matrices; "xavier": xavier-normal matrices
    transformer_init: str = "normal002"
    # "normal002" or "zeros"
    proj_out_init: str = "normal002"

    def __init__(self, in_features: int, out_features: int = 768, num_image_tokens: int = 4,
                 num_layers: int = 1, num_heads: int = 8, mlp_ratio: float = 4.0,
                 attn_implementation: str = "xla"):
        super().__init__()
        self.out_features = out_features
        self.num_tokens = num_image_tokens
        self.register_parameter(
            self.query_key, nn.Parameter(torch.empty(1, num_image_tokens, out_features))
        )
        self.proj_in = Linear(in_features, out_features)
        self.transformer = nn.ModuleDict(
            {
                str(i): PerceiverTransformer(out_features, num_heads, mlp_ratio, attn_implementation)
                for i in range(num_layers)
            }
        )
        self.norm_out = LayerNorm(out_features, eps=1e-6, elementwise_affine=False)
        self.proj_out = Linear(out_features, out_features)

    @property
    def query(self) -> nn.Parameter:
        return getattr(self, self.query_key)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.query.normal_(0.0, 1.0, generator=generator).div_(self.out_features**0.5)

    def _init_matrix(self, weight: torch.Tensor, generator: torch.Generator) -> None:
        if self.transformer_init == "normal002":
            weight.normal_(0.0, 0.02, generator=generator)
        else:
            xavier_normal_(weight, generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        init_parameters_(self, generator)
        for layer in self.transformer.values():
            for name in ("to_q", "to_k", "to_v", "to_out"):
                self._init_matrix(layer[name].weight, generator)
            for name in ("0", "2"):
                self._init_matrix(layer["mlp"][name].weight, generator)
                layer["mlp"][name].bias.zero_()
            layer["to_out"].bias.zero_()
        if self.proj_out_init == "zeros":
            self.proj_out.weight.zero_()
        else:
            self.proj_out.weight.normal_(0.0, 0.02, generator=generator)
        self.proj_out.bias.zero_()

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if features.ndim == 2:
            features = features[:, None, :]
        query = self.query.to(features.dtype).expand(features.shape[0], -1, -1)
        h = self.proj_in(features)
        for layer in self.transformer.values():
            query = layer(query, h)
        return self.norm_out(self.proj_out(query))


class PFGConfig(BaseModel):
    num_image_tokens: int = 4
    image_size: int = 384
    background_color: int = 0

    projector_type: Literal["linear", "mlp", "resampler"] = "mlp"
    projector_args: dict = {}

    checkpoint_weight: Optional[str] = None

    image_encoder: dict = {}  # AutoModelConfig fields (models/auto.py)
    image_mean: list[float] = [0.5, 0.5, 0.5]
    image_std: list[float] = [0.5, 0.5, 0.5]
    color_channel: Literal["rgb", "bgr"] = "rgb"
    feature_dim: int = 768


class PFGManager:
    def __init__(self, adapter_config: PFGConfig):
        self.adapter_config = adapter_config

    def get_projector(self, out_features: int) -> nn.Module:
        cfg = self.adapter_config
        args = cfg.projector_args
        if cfg.projector_type == "linear":
            return LinearImageProjector(cfg.feature_dim, out_features, cfg.num_image_tokens)
        if cfg.projector_type == "mlp":
            return MLPImageProjector(cfg.feature_dim, out_features, cfg.num_image_tokens,
                                     mlp_ratio=args.get("mlp_ratio", 4.0))
        if cfg.projector_type == "resampler":
            return ResamplerImageProjector(
                cfg.feature_dim, out_features, cfg.num_image_tokens,
                num_layers=args.get("num_layers", 1), num_heads=args.get("num_heads", 8),
                mlp_ratio=args.get("mlp_ratio", 4.0),
            )
        raise ValueError(f"Invalid projector type: {cfg.projector_type}")
