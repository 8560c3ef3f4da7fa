"""UMT5 encoder (``vision_ft_tpu/models/text_encoders/umt5.py``
counterpart; the Hugging Face ``UMT5EncoderModel`` as AuraFlow's Pile-T5-XL
text tower instantiates it):

- RMS layer norms (no mean, no bias), fp32 statistics
- gated-act FFN (``gelu_new``: the tanh GELU)
- no 1/sqrt(d) attention scaling (the T5 convention)
- a relative position bias in every layer (UMT5; classic T5 shares the
  first layer's with ``per_layer_relative_bias=False``)

The attention is the plain formula with fp32 logits over (B, H, S, D)
(``attention_backend="xla"``, as in the JAX package, which sends it to no
kernel: the bias is a full (H, S, S) table). Parameter keys follow the
Hugging Face layout (``shared.weight``, ``encoder.embed_tokens.weight``,
``encoder.block.N.layer.0.SelfAttention.q.weight``, ...). ``shared`` and
``encoder.embed_tokens`` are two parameters, as they are two leaves of the
JAX package's tree; the forward reads ``embed_tokens``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Embedding, Linear, RMSNorm
from ...ops.attention import scaled_dot_product_attention


@dataclasses.dataclass
class UMT5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dense_act_fn: str = "gelu_new"
    attention_backend: str = "xla"
    # UMT5: every layer owns a relative bias; classic T5: only block 0 owns
    # it and all layers share it
    per_layer_relative_bias: bool = True


# AuraFlow's Pile-T5-XL config
AURAFLOW_UMT5_CONFIG = UMT5Config()

_ACTS = {
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
}


def relative_position_bucket(
    relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128
) -> np.ndarray:
    """Bidirectional T5 bucket mapping (the encoder's), static numpy."""
    num_buckets //= 2
    buckets = (relative_position > 0).astype(np.int64) * num_buckets
    rel = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    safe_rel = np.maximum(rel, 1)  # log's argument; values < max_exact are masked by is_small
    log_ratio = np.log(safe_rel.astype(np.float64) / max_exact) / math.log(
        max_distance / max_exact
    )
    large = max_exact + (log_ratio * (num_buckets - max_exact)).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    return buckets + np.where(is_small, rel, large)


class UMT5Attention(nn.ModuleDict):
    def __init__(self, config: UMT5Config, has_relative_bias: bool = True):
        inner = config.num_heads * config.d_kv
        children = {
            "q": Linear(config.d_model, inner, bias=False),
            "k": Linear(config.d_model, inner, bias=False),
            "v": Linear(config.d_model, inner, bias=False),
            "o": Linear(inner, config.d_model, bias=False),
        }
        if has_relative_bias:
            children["relative_attention_bias"] = Embedding(
                config.relative_attention_num_buckets, config.num_heads
            )
        super().__init__(children)
        self.config = config
        self.n_heads = config.num_heads
        self.d_kv = config.d_kv

    def position_bias(self, seq_len: int) -> torch.Tensor:
        """(1, heads, seq, seq) additive bias; the bucket table is static."""
        positions = np.arange(seq_len)
        buckets = relative_position_bucket(
            positions[None, :] - positions[:, None],
            self.config.relative_attention_num_buckets,
            self.config.relative_attention_max_distance,
        )
        table = self["relative_attention_bias"]
        ids = torch.from_numpy(buckets).to(table.weight.device)
        return table(ids).permute(2, 0, 1)[None]  # (1, heads, seq, seq)

    def forward(self, x, mask: Optional[torch.Tensor] = None,
                position_bias: Optional[torch.Tensor] = None):
        b, s, _ = x.shape
        h, d = self.n_heads, self.d_kv

        def heads(t):
            return t.reshape(b, s, h, d).transpose(1, 2)

        q, k, v = (heads(self[name](x)) for name in ("q", "k", "v"))
        bias = (position_bias if position_bias is not None else self.position_bias(s)).float()
        if mask is not None:
            # additive: 0 keep, -1e9 drop, broadcast over (B, 1, 1, S)
            bias = bias + torch.where(mask[:, None, None, :], 0.0, -1e9)
        # T5: no 1/sqrt(d) scaling (folded into the init)
        attn = scaled_dot_product_attention(
            q, k, v, mask=bias, scale=1.0, backend=self.config.attention_backend
        )
        return self["o"](attn.transpose(1, 2).reshape(b, s, h * d))


class UMT5Block(nn.ModuleDict):
    def __init__(self, config: UMT5Config, has_relative_bias: bool = True):
        eps = config.layer_norm_epsilon
        super().__init__(
            {
                "layer": nn.ModuleDict(
                    {
                        "0": nn.ModuleDict(
                            {
                                "SelfAttention": UMT5Attention(config, has_relative_bias),
                                "layer_norm": RMSNorm(config.d_model, eps),
                            }
                        ),
                        "1": nn.ModuleDict(
                            {
                                "DenseReluDense": nn.ModuleDict(
                                    {
                                        "wi_0": Linear(config.d_model, config.d_ff, bias=False),
                                        "wi_1": Linear(config.d_model, config.d_ff, bias=False),
                                        "wo": Linear(config.d_ff, config.d_model, bias=False),
                                    }
                                ),
                                "layer_norm": RMSNorm(config.d_model, eps),
                            }
                        ),
                    }
                )
            }
        )
        self.act = _ACTS[config.dense_act_fn]

    def forward(self, x, mask=None, position_bias=None):
        l0, l1 = self["layer"]["0"], self["layer"]["1"]
        x = x + l0["SelfAttention"](l0["layer_norm"](x), mask, position_bias)
        normed = l1["layer_norm"](x)
        ff = l1["DenseReluDense"]
        return x + ff["wo"](self.act(ff["wi_0"](normed)) * ff["wi_1"](normed))


class UMT5EncoderModel(nn.Module):
    """Keys: ``shared.weight`` + ``encoder.{embed_tokens, block.N,
    final_layer_norm}``."""

    def __init__(self, config: UMT5Config):
        super().__init__()
        self.config = config
        self.shared = Embedding(config.vocab_size, config.d_model)
        self.encoder = nn.ModuleDict(
            {
                "embed_tokens": Embedding(config.vocab_size, config.d_model),
                "block": nn.ModuleDict(
                    {
                        str(i): UMT5Block(
                            config, has_relative_bias=config.per_layer_relative_bias or i == 0
                        )
                        for i in range(config.num_layers)
                    }
                ),
                "final_layer_norm": RMSNorm(config.d_model, config.layer_norm_epsilon),
            }
        )

    @torch.no_grad()
    def tie_embeddings(self) -> None:
        """After a random init: ``encoder.embed_tokens`` takes ``shared``'s
        values, as the JAX ``init`` makes the two leaves one array."""
        self.encoder["embed_tokens"].weight.copy_(self.shared.weight)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """last_hidden_state (B, S, d_model)."""
        x = self.encoder["embed_tokens"](input_ids)
        mask = attention_mask.bool() if attention_mask is not None else None
        blocks = list(self.encoder["block"].values())
        shared_bias = None
        if not self.config.per_layer_relative_bias:
            shared_bias = blocks[0]["layer"]["0"]["SelfAttention"].position_bias(x.shape[1])
        for i, block in enumerate(blocks):
            bias = shared_bias if (shared_bias is not None and i > 0) else None
            x = block(x, mask, bias)
        return self.encoder["final_layer_norm"](x)
