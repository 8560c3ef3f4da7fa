"""CLIP vision tower in the HF ``CLIPVisionModel[WithProjection]`` key
layout (``vision_ft_tpu/models/vision_encoders/clip_vision.py``
counterpart): ``vision_model.embeddings.{class_embedding,
patch_embedding.weight, position_embedding.weight}``,
``vision_model.pre_layrnorm.*`` (HF's spelling), ``vision_model.encoder.
layers.N.*``, ``vision_model.post_layernorm.*``, ``visual_projection.
weight``, so CLIP / PickScore checkpoints load directly. It is
differentiable through the pixels. Its attention takes the plain formula
(``attention_backend`` "xla"), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...nn import Embedding, LayerNorm, Linear
from ...ops.attention import AttentionImplementation
from ...utils.tensor import resize_cubic
from ..text_encoders.clip import CLIPEncoderLayer


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768
    attention_backend: AttentionImplementation = "xla"

    # the text layer reads these names; vision has no vocabulary
    @property
    def max_position_embeddings(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


# PickScore_v1 / laion CLIP-H vision tower
PICKSCORE_VISION_CONFIG = CLIPVisionConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=16,
    patch_size=14,
    hidden_act="gelu",
    projection_dim=1024,
)

# CLIP normalization constants (HF CLIPImageProcessor defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class _PatchWeight(nn.Module):
    """The patch convolution's weight (no bias), held for its key."""

    def __init__(self, shape):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 0.02, generator=generator)


class _Embeddings(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        d, p = config.hidden_size, config.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.patch_embedding = _PatchWeight((d, config.num_channels, p, p))
        self.position_embedding = Embedding(config.max_position_embeddings, d)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.class_embedding.normal_(0.0, 0.02, generator=generator)


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values NHWC normalized)`` -> (last_hidden_state,
    pooled), pooled = the post-LN class token."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = nn.Module()
        self.vision_model.embeddings = _Embeddings(config)
        self.vision_model.pre_layrnorm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)
        self.vision_model.encoder = nn.Module()
        self.vision_model.encoder.layers = nn.ModuleDict(
            {str(i): CLIPEncoderLayer(config) for i in range(config.num_hidden_layers)}
        )
        self.vision_model.post_layernorm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps)

    def _embed(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        emb = self.vision_model.embeddings
        # a non-overlapping patch conv as a reshape and one matmul
        b, h, w, c = pixel_values.shape
        p = cfg.patch_size
        x = pixel_values.reshape(b, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, (h // p) * (w // p), c * p * p)
        weight = emb.patch_embedding.weight
        patches = x @ weight.reshape(weight.shape[0], -1).to(x.dtype).t()  # no bias
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, cfg.hidden_size)
        tokens = torch.cat([cls, patches], dim=1)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        return tokens + emb.position_embedding(positions)

    def forward(self, pixel_values: torch.Tensor):
        vm = self.vision_model
        x = vm.pre_layrnorm(self._embed(pixel_values))
        for layer in vm.encoder.layers.values():
            x = layer(x, None)
        return x, vm.post_layernorm(x[:, 0])


class CLIPVisionModelWithProjection(CLIPVisionModel):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__(config)
        self.visual_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor):
        last, pooled = super().forward(pixel_values)
        return last, self.visual_projection(pooled)


def clip_preprocess(images: torch.Tensor, image_size: int = 224, antialias: bool = True) -> torch.Tensor:
    """NHWC float in [-1, 1] -> resized (bicubic), CLIP-normalized NHWC
    fp32; differentiable."""
    x = (images.float() + 1.0) / 2.0
    x = resize_cubic(x, image_size, image_size, antialias=antialias)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
