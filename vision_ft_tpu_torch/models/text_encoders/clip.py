"""CLIP text encoder (``vision_ft_tpu/models/text_encoders/clip.py``
counterpart), HF-transformers key layout
(``text_model.encoder.layers.N.self_attn.q_proj...``).

Inputs are (B, S) int token ids. The causal mask is an additive fp32
bias; attention is the plain formula (S = 77 < 256, as in the JAX
package). Its LayerNorms (C 768 or 1280) take the fused LayerNorm
kernel for bf16 CUDA tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Embedding, LayerNorm, Linear
from ...ops.attention import AttentionImplementation, scaled_dot_product_attention


@dataclass
class CLIPTextConfig:
    """Subset of HF CLIPTextConfig the text tower needs."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: Literal["quick_gelu", "gelu"] = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 2
    projection_dim: int = 768
    attention_backend: AttentionImplementation = "xla"


# SDXL text encoder 1: OpenAI CLIP ViT-L/14 text tower
SDXL_TEXT_ENCODER_1_CONFIG = CLIPTextConfig(
    hidden_size=768,
    intermediate_size=3072,
    num_hidden_layers=12,
    num_attention_heads=12,
    hidden_act="quick_gelu",
    projection_dim=768,
)

# SDXL text encoder 2: OpenCLIP bigG text tower
SDXL_TEXT_ENCODER_2_CONFIG = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


class CLIPAttention(nn.ModuleDict):
    def __init__(self, config: CLIPTextConfig):
        d = config.hidden_size
        super().__init__(
            {
                "q_proj": Linear(d, d),
                "k_proj": Linear(d, d),
                "v_proj": Linear(d, d),
                "out_proj": Linear(d, d),
            }
        )
        self.num_heads = config.num_attention_heads
        self.backend = config.attention_backend

    def forward(self, x, bias):
        b, s, d = x.shape

        def heads(t):
            return t.reshape(b, s, self.num_heads, -1).transpose(1, 2)

        q = heads(self["q_proj"](x))
        k = heads(self["k_proj"](x))
        v = heads(self["v_proj"](x))
        attn = scaled_dot_product_attention(q, k, v, mask=bias, backend=self.backend)
        return self["out_proj"](attn.transpose(1, 2).reshape(b, s, d))


class CLIPEncoderLayer(nn.ModuleDict):
    def __init__(self, config: CLIPTextConfig):
        d = config.hidden_size
        super().__init__(
            {
                "self_attn": CLIPAttention(config),
                "layer_norm1": LayerNorm(d, eps=config.layer_norm_eps),
                "mlp": nn.ModuleDict(
                    {
                        "fc1": Linear(d, config.intermediate_size),
                        "fc2": Linear(config.intermediate_size, d),
                    }
                ),
                "layer_norm2": LayerNorm(d, eps=config.layer_norm_eps),
            }
        )
        self.hidden_act = config.hidden_act

    def forward(self, x, bias):
        x = x + self["self_attn"](self["layer_norm1"](x), bias)
        h = self["mlp"]["fc1"](self["layer_norm2"](x))
        return x + self["mlp"]["fc2"](_act(self.hidden_act, h))


class CLIPTextModel(nn.Module):
    """Text tower. ``forward(input_ids)`` returns (last_hidden_state,
    penultimate hidden state, pooled). ``pooled`` is taken at the first
    position of the real eos id (``vocab_size - 1``) in each row."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = nn.ModuleDict(
            {
                "embeddings": nn.ModuleDict(
                    {
                        "token_embedding": Embedding(config.vocab_size, config.hidden_size),
                        "position_embedding": Embedding(
                            config.max_position_embeddings, config.hidden_size
                        ),
                    }
                ),
                "encoder": nn.ModuleDict(
                    {
                        "layers": nn.ModuleDict(
                            {
                                str(i): CLIPEncoderLayer(config)
                                for i in range(config.num_hidden_layers)
                            }
                        )
                    }
                ),
                "final_layer_norm": LayerNorm(config.hidden_size, eps=config.layer_norm_eps),
            }
        )

    def forward(self, input_ids: torch.Tensor):
        tm = self.text_model
        s = input_ids.shape[-1]
        positions = torch.arange(s, device=input_ids.device)
        x = tm["embeddings"]["token_embedding"](input_ids)
        x = x + tm["embeddings"]["position_embedding"](positions)

        # additive causal bias (finfo.min, as HF: -inf risks NaN rows)
        neg = torch.finfo(torch.float32).min
        bias = torch.full((s, s), neg, dtype=torch.float32, device=x.device).triu(1)[None, None]

        layers = list(tm["encoder"]["layers"].values())
        penultimate = x
        for i, layer in enumerate(layers):
            if i == len(layers) - 1:
                penultimate = x
            x = layer(x, bias)
        last = tm["final_layer_norm"](x)

        eos_id = self.config.vocab_size - 1  # 49407 for CLIP vocabs
        eos_positions = (input_ids == eos_id).int().argmax(dim=-1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_positions]
        return last, penultimate, pooled


class CLIPTextModelWithProjection(CLIPTextModel):
    """Adds the bias-free text_projection on the pooled embedding."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__(config)
        self.text_projection = Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor):
        last, penultimate, pooled = super().forward(input_ids)
        return last, penultimate, self.text_projection(pooled)
