"""Autoregressive guiding-pixel transformer (``vision_ft_tpu/models/fractal/pixel.py``
counterpart): a 4-token causal transformer [condition, R, G, B] that
predicts 256-way logits a channel, its embeddings tied to the heads'
projections. Its 4-token attention takes the plain formula on every
device, as in the JAX package; its LayerNorms are kernel A's on the card
(bf16, a width that is a multiple of 128)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import LayerNorm, Linear
from ...ops.attention import scaled_dot_product_attention


class PixelHead(nn.ModuleDict):
    """Tied embedding / classifier: ``encode`` gathers rows of
    ``proj.weight``; ``forward`` applies ``proj.weight`` with the separate
    ``bias`` parameter (``proj.bias`` is in the state dict and unused, as
    in the JAX package and upstream)."""

    def __init__(self, vocab_size: int, hidden_dim: int):
        super().__init__({"proj": Linear(hidden_dim, vocab_size)})
        self.vocab_size = vocab_size
        self.bias = nn.Parameter(torch.empty(vocab_size))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.zeros_(self.bias)

    def encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        return self["proj"].weight[pixel_values]

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return hidden_states @ self["proj"].weight.t() + self.bias


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D) view"""
    return t.unflatten(-1, (h, t.shape[-1] // h)).transpose(1, 2)


class PixelTransformerBlock(nn.ModuleDict):
    def __init__(self, hidden_dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 backend: str = "xla"):
        inner = int(hidden_dim * mlp_ratio)
        super().__init__({
            "norm1": LayerNorm(hidden_dim),
            "attn": nn.ModuleDict({
                "to_q": Linear(hidden_dim, hidden_dim, bias=True),
                "to_k": Linear(hidden_dim, hidden_dim, bias=True),
                "to_v": Linear(hidden_dim, hidden_dim, bias=True),
                "to_o": Linear(hidden_dim, hidden_dim),
            }),
            "norm2": LayerNorm(hidden_dim),
            "mlp": nn.ModuleDict({"fc1": Linear(hidden_dim, inner), "fc2": Linear(inner, hidden_dim)}),
        })
        self.num_heads = num_heads
        self.backend = backend

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        a, h = self["attn"], self.num_heads
        out = scaled_dot_product_attention(
            _heads(a["to_q"](x), h), _heads(a["to_k"](x), h), _heads(a["to_v"](x), h),
            is_causal=True, backend=self.backend)
        return a["to_o"](out.transpose(1, 2).flatten(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attention(self["norm1"](x))
        h = F.gelu(self["mlp"]["fc1"](self["norm2"](x)), approximate="none")
        return x + self["mlp"]["fc2"](h)


class PixelTransformerOutput(NamedTuple):
    logits: torch.Tensor  # (B, 3 * 256)
    labels: torch.Tensor  # (B, 3) int32


class PixelTransformer(nn.Module):
    def __init__(self, channels: int, hidden_dim: int, num_blocks: int, num_heads: int,
                 attention_backend: str = "xla"):
        super().__init__()
        self.condition_proj = Linear(channels, hidden_dim)
        self.red_head = PixelHead(256, hidden_dim)
        self.green_head = PixelHead(256, hidden_dim)
        self.blue_head = PixelHead(256, hidden_dim)
        self.pre_ln = LayerNorm(hidden_dim, eps=1e-6)
        self.blocks = nn.ModuleList(
            PixelTransformerBlock(hidden_dim, num_heads, backend=attention_backend)
            for _ in range(num_blocks)
        )
        self.post_ln = LayerNorm(hidden_dim, eps=1e-6)

    @staticmethod
    def labels_of(ground_truth: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """round(ground_truth * 255 + noise), half to even, as int32: the
        dither before rounding keeps labels off the ties."""
        return torch.round(ground_truth.float() * 255.0 + noise.float()).to(torch.int32)

    def forward(
        self,
        guiding_condition: torch.Tensor,  # (B, S, C): only token 0 is read
        ground_truth: torch.Tensor,  # (B, 3) in [0, 1]
        generator: Optional[torch.Generator] = None,
        labels: Optional[torch.Tensor] = None,
    ) -> PixelTransformerOutput:
        """``labels`` (B, 3) given, or drawn: ground truth dithered by
        1e-2 x a standard normal from ``generator``."""
        if labels is None:
            noise = torch.randn(ground_truth.shape, generator=generator,
                                device=generator.device if generator is not None else None)
            labels = self.labels_of(ground_truth, noise.to(ground_truth.device) * 1e-2)
        labels = labels.to(torch.int32)
        index = labels.long()
        condition = self.condition_proj(guiding_condition[:, 0])
        x = torch.stack([
            condition,
            self.red_head.encode(index[:, 0]).to(condition.dtype),
            self.green_head.encode(index[:, 1]).to(condition.dtype),
            self.blue_head.encode(index[:, 2]).to(condition.dtype),
        ], dim=1)
        x = self.pre_ln(x)
        for block in self.blocks:
            x = block(x)
        x = self.post_ln(x)
        logits = torch.cat([
            self.red_head(x[:, 0]), self.green_head(x[:, 1]), self.blue_head(x[:, 2]),
        ], dim=1)
        return PixelTransformerOutput(logits=logits, labels=labels)
