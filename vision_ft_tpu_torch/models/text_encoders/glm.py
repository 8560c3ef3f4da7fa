"""GLM-4 decoder LM, used as an encoder
(``vision_ft_tpu/models/text_encoders/glm.py`` counterpart; the Hugging
Face ``GlmModel`` as CogView4's text tower instantiates it):

- partial rotary: the first ``head_dim * partial_rotary_factor`` columns
  of each head rotate, pairs (2i, 2i+1) interleaved, fp32; the rest pass
  through
- grouped-query attention (q/k/v projections with bias, o_proj without),
  causal masking and an optional padding mask
- the fused ``gate_up_proj`` SwiGLU MLP
- RMSNorm pre-norm layers

The attention is a plain formula with fp32 logits, as in the JAX package
(backend "xla": it has no kernel for the causal, masked attention); its
matrix products are library calls.

Returns (final_normed, penultimate): CogView4 consumes the penultimate
hidden state (the input of the last decoder layer). Parameter keys follow
the Hugging Face layout (embed_tokens.weight,
layers.N.self_attn.q_proj.weight, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Embedding, Linear, RMSNorm


@dataclasses.dataclass
class GlmConfig:
    vocab_size: int = 151552
    hidden_size: int = 4096
    intermediate_size: int = 13696
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 2
    head_dim: int = 128
    partial_rotary_factor: float = 0.5
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1.5625e-07
    attention_bias: bool = True
    attention_backend: str = "xla"


# CogView4's GLM-4-9B text tower
COGVIEW4_GLM_CONFIG = GlmConfig()


def _rotary_tables(s: int, theta: float, rotary_dim: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (S, rotary_dim), each angle twice in a row, from
    fp64 numpy as the JAX package builds them."""
    inv_freq = 1.0 / (theta ** (np.arange(0, rotary_dim, 2, dtype=np.float64) / rotary_dim))
    angles = np.outer(np.arange(s, dtype=np.float64), inv_freq)
    cos = torch.from_numpy(np.repeat(np.cos(angles), 2, axis=-1).astype(np.float32))
    sin = torch.from_numpy(np.repeat(np.sin(angles), 2, axis=-1).astype(np.float32))
    return cos.to(device), sin.to(device)


def _glm_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved partial rotary on (B, H, S, D) in fp32 (Hugging Face's
    ``modeling_glm.apply_rotary_pos_emb``): pairs (2i, 2i+1) of the first
    ``cos.shape[-1]`` columns rotate, the rest pass through."""
    rotary_dim = cos.shape[-1]
    xf = x.float()
    x_rot, x_pass = xf[..., :rotary_dim], xf[..., rotary_dim:]
    even, odd = x_rot[..., 0::2], x_rot[..., 1::2]
    rotated = torch.stack([-odd, even], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot * cos + rotated * sin, x_pass], dim=-1).to(x.dtype)


class GlmAttention(nn.ModuleDict):
    def __init__(self, config: GlmConfig):
        self.config = config
        h, kv, d = config.num_attention_heads, config.num_key_value_heads, config.head_dim
        super().__init__(
            {
                "q_proj": Linear(config.hidden_size, h * d, bias=config.attention_bias),
                "k_proj": Linear(config.hidden_size, kv * d, bias=config.attention_bias),
                "v_proj": Linear(config.hidden_size, kv * d, bias=config.attention_bias),
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

        cos, sin = _rotary_tables(s, cfg.rope_theta, int(d * cfg.partial_rotary_factor), x.device)
        q, k = _glm_rotary(q, cos, sin), _glm_rotary(k, cos, sin)

        rep = h // kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

        # fp32 logits from the inputs' values (a bf16 product summed in fp32)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        logits = torch.where(mask, logits, -1e30)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, h * d)
        return self["o_proj"](attn)


class GlmMLP(nn.ModuleDict):
    def __init__(self, config: GlmConfig):
        super().__init__(
            {
                "gate_up_proj": Linear(config.hidden_size, 2 * config.intermediate_size, bias=False),
                "down_proj": Linear(config.intermediate_size, config.hidden_size, bias=False),
            }
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = self["gate_up_proj"](x).chunk(2, dim=-1)
        return self["down_proj"](up * F.silu(gate))


class GlmLayer(nn.ModuleDict):
    def __init__(self, config: GlmConfig):
        super().__init__(
            {
                "self_attn": GlmAttention(config),
                "mlp": GlmMLP(config),
                "input_layernorm": RMSNorm(config.hidden_size, config.rms_norm_eps),
                "post_attention_layernorm": RMSNorm(config.hidden_size, config.rms_norm_eps),
            }
        )

    def forward(self, x: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self["self_attn"](self["input_layernorm"](x), attention_mask)
        return x + self["mlp"](self["post_attention_layernorm"](x))


class GlmModel(nn.Module):
    def __init__(self, config: GlmConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size)
        self.layers = nn.ModuleDict(
            {str(i): GlmLayer(config) for i in range(config.num_hidden_layers)}
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (last_hidden_state [final-normed], penultimate), the
        penultimate being the input of the last decoder layer (Hugging
        Face's ``hidden_states[-2]``)."""
        x = self.embed_tokens(input_ids)
        penultimate = x
        for layer in self.layers.values():
            penultimate = x
            x = layer(x, attention_mask)
        return self.norm(x), penultimate
