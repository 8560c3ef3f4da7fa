"""Gemma-2 decoder-only LM, used as an encoder
(``vision_ft_tpu/models/text_encoders/gemma2.py`` counterpart; the Hugging
Face ``Gemma2Model`` as Lumina2's text tower instantiates it):

- embeddings scaled by sqrt(hidden_size)
- Gemma RMSNorm with (1 + weight) scaling, the weight stored as the offset
- grouped-query attention with rotary embeddings (rotate-half, fp32), query
  scale = query_pre_attn_scalar^-0.5, tanh soft-capping of the logits (50),
  causal masking, a sliding window on the even layers, the padding mask
- sandwich norms: input / post_attention and pre / post_feedforward
- gelu_tanh gated MLP

The attention is a plain formula with fp32 logits, as in the JAX package
(which has no kernel for it: soft-capping sits between the scores and the
softmax); its matrix products are library calls.

Returns (final_normed, penultimate): Lumina2 consumes the penultimate
hidden state (the input of the last decoder layer). Parameter keys follow
the Hugging Face layout (embed_tokens.weight,
layers.N.self_attn.q_proj.weight, ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Embedding, Linear, RMSNorm


@dataclasses.dataclass
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    query_pre_attn_scalar: float = 256.0
    attn_logit_softcapping: Optional[float] = 50.0
    sliding_window: int = 4096
    attention_backend: str = "xla"


# Lumina2's Gemma-2-2B config
LUMINA2_GEMMA2_CONFIG = Gemma2Config()


class Gemma2RMSNorm(RMSNorm):
    """Gemma's RMSNorm: the weight is the offset from 1 (zeros at init)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.zeros_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + self.eps)
        return (h * (1.0 + self.weight.float())).to(x.dtype)


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on (B, H, S, D): rotate-half formulation, fp32,
    angles computed in fp64 as the JAX package's tables are."""
    d, s = x.shape[-1], x.shape[-2]
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    )
    angles = torch.outer(torch.arange(s, dtype=torch.float64, device=x.device), inv_freq)
    cos = torch.cat([angles.cos(), angles.cos()], dim=-1).float()  # (S, D)
    sin = torch.cat([angles.sin(), angles.sin()], dim=-1).float()
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


class Gemma2Attention(nn.ModuleDict):
    def __init__(self, config: Gemma2Config, layer_idx: int):
        self.config = config
        self.layer_idx = layer_idx
        # a sliding window on the even layers
        self.is_sliding = layer_idx % 2 == 0
        h, kv, d = config.num_attention_heads, config.num_key_value_heads, config.head_dim
        super().__init__(
            {
                "q_proj": Linear(config.hidden_size, h * d, bias=False),
                "k_proj": Linear(config.hidden_size, kv * d, bias=False),
                "v_proj": Linear(config.hidden_size, kv * d, bias=False),
                "o_proj": Linear(h * d, config.hidden_size, bias=False),
            }
        )

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        b, s, _ = x.shape
        h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

        q = self["q_proj"](x).reshape(b, s, h, d).transpose(1, 2)
        k = self["k_proj"](x).reshape(b, s, kv, d).transpose(1, 2)
        v = self["v_proj"](x).reshape(b, s, kv, d).transpose(1, 2)

        q = _rotary(q, cfg.rope_theta)
        k = _rotary(k, cfg.rope_theta)

        rep = h // kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

        # fp32 logits from the inputs' values (a bf16 product summed in fp32)
        scale = cfg.query_pre_attn_scalar**-0.5
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if cfg.attn_logit_softcapping is not None:
            cap = cfg.attn_logit_softcapping
            logits = cap * torch.tanh(logits / cap)

        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        if self.is_sliding and s > cfg.sliding_window:
            mask = mask & torch.ones_like(mask).triu(-cfg.sliding_window + 1)
        mask = mask[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        logits = torch.where(mask, logits, -1e30)

        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(weights, v)
        attn = attn.transpose(1, 2).reshape(b, s, h * d)
        return self["o_proj"](attn)


class Gemma2MLP(nn.ModuleDict):
    def __init__(self, config: Gemma2Config):
        super().__init__(
            {
                "gate_proj": Linear(config.hidden_size, config.intermediate_size, bias=False),
                "up_proj": Linear(config.hidden_size, config.intermediate_size, bias=False),
                "down_proj": Linear(config.intermediate_size, config.hidden_size, bias=False),
            }
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = F.gelu(self["gate_proj"](x), approximate="tanh")
        return self["down_proj"](gate * self["up_proj"](x))


class Gemma2Layer(nn.ModuleDict):
    def __init__(self, config: Gemma2Config, layer_idx: int):
        norm = lambda: Gemma2RMSNorm(config.hidden_size, eps=config.rms_norm_eps)  # noqa: E731
        super().__init__(
            {
                "self_attn": Gemma2Attention(config, layer_idx),
                "mlp": Gemma2MLP(config),
                "input_layernorm": norm(),
                "post_attention_layernorm": norm(),
                "pre_feedforward_layernorm": norm(),
                "post_feedforward_layernorm": norm(),
            }
        )

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        h = self["self_attn"](self["input_layernorm"](x), attention_mask)
        x = x + self["post_attention_layernorm"](h)
        h = self["mlp"](self["pre_feedforward_layernorm"](x))
        return x + self["post_feedforward_layernorm"](h)


class Gemma2Model(nn.Module):
    def __init__(self, config: Gemma2Config):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleDict(
            {str(i): Gemma2Layer(config, i) for i in range(config.num_hidden_layers)}
        )
        self.norm = Gemma2RMSNorm(config.hidden_size, eps=config.rms_norm_eps)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (last_hidden_state [final-normed], penultimate), the
        penultimate being the input of the last decoder layer (Hugging
        Face's ``hidden_states[-2]``)."""
        x = self.embed_tokens(input_ids)
        # the factor rounded to x's dtype, as the JAX package multiplies
        x = x * torch.tensor(math.sqrt(self.config.hidden_size), dtype=x.dtype).item()
        penultimate = x
        for layer in self.layers.values():
            penultimate = x
            x = layer(x, attention_mask)
        return self.norm(x), penultimate
