"""Wan 2.2 text encoder (``vision_ft_tpu/models/wan/text_encoder.py``
counterpart): Alibaba's UMT5-variant encoder.

- A T5-style encoder whose every block owns its relative position bias
  (``pos_embedding.embedding``, 32 bidirectional buckets).
- The norms are mean-subtracting LayerNorms with a weight and no bias
  (``nn.LayerNorm(dim, bias=False)``, fp32 statistics). On the card a bf16
  input goes through the fused LayerNorm kernel A without beta at C 4096
  (the rule of ``nn.core.LayerNorm``): two a block and the final one, 49
  for the 24 layers of the published encoder, one launch each per prompt
  encoding.
- Attention logits are not scaled; the bias is added, masked keys get the
  fp32 minimum, the softmax runs in fp32 and its weights are cast to v's
  dtype: the plain formula, as in the JAX package.
- The feed-forward is gated: ``fc2(fc1(x) * gelu_erf(gate(x)))``.

Defaults: Wan-AI/Wan2.2-TI2V-5B, vocab 256384, dim 4096, ffn 10240, 64
heads, 24 layers. Keys under the pipeline's ``model.`` prefix:
token_embedding.weight, blocks.N.{norm1,norm2}.weight,
blocks.N.attn.{q,k,v,o}.weight, blocks.N.ffn.{gate.0,fc1,fc2}.weight,
blocks.N.pos_embedding.embedding.weight, norm.weight.

Prompts are tokenized to the longest in the call; rows a tokenizer leaves
unequal (one that does not pad to the longest itself, where the JAX
package's ``np.asarray`` raises) are padded to the longest on the
tokenizer's ``padding_side`` (right where it names none) with its
``pad_token_id`` (0 without one), and masked.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from pydantic import BaseModel
from torch import nn

from ...nn import Embedding, LayerNorm, Linear
from ..utils import PromptType, TextEncodingOutput

DEFAULT_MAX_TOKEN_LENGTH = 512


class TextEncoderConfig(BaseModel):
    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False
    dropout: float = 0.1  # inference path: inert


def _relative_position_bucket(rel_pos: np.ndarray, num_buckets: int,
                              max_dist: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket of each relative position, on the host."""
    half = num_buckets // 2
    rel_buckets = (rel_pos > 0).astype(np.int64) * half
    rel_pos = np.abs(rel_pos)
    max_exact = half // 2
    rel_pos_large = max_exact + (
        np.log(np.maximum(rel_pos, 1).astype(np.float32) / max_exact)
        / math.log(max_dist / max_exact)
        * (half - max_exact)
    ).astype(np.int64)
    rel_pos_large = np.minimum(rel_pos_large, half - 1)
    rel_buckets += np.where(rel_pos < max_exact, rel_pos, rel_pos_large)
    return rel_buckets


@functools.lru_cache(maxsize=16)
def _bucket_table(lq: int, lk: int, num_buckets: int) -> np.ndarray:
    rel_pos = np.arange(lk)[None, :] - np.arange(lq)[:, None]
    return _relative_position_bucket(rel_pos, num_buckets)


class T5RelativeEmbedding(nn.Module):
    def __init__(self, num_buckets: int, num_heads: int):
        super().__init__()
        self.num_buckets = num_buckets
        self.embedding = Embedding(num_buckets, num_heads)

    def forward(self, lq: int, lk: int) -> torch.Tensor:
        buckets = torch.from_numpy(_bucket_table(lq, lk, self.num_buckets)).to(
            self.embedding.weight.device)
        bias = self.embedding(buckets)  # (Lq, Lk, H)
        return bias.permute(2, 0, 1)[None]  # (1, H, Lq, Lk)


class T5Attention(nn.Module):
    """Unscaled multi-head attention with an additive position bias."""

    def __init__(self, dim: int, dim_attn: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim_attn // num_heads
        self.q = Linear(dim, dim_attn, bias=False)
        self.k = Linear(dim, dim_attn, bias=False)
        self.v = Linear(dim, dim_attn, bias=False)
        self.o = Linear(dim_attn, dim, bias=False)

    def forward(self, x, mask=None, pos_bias=None):
        b, s, _ = x.shape
        n, c = self.num_heads, self.head_dim

        def heads(t):
            return t.reshape(b, s, n, c).transpose(1, 2)  # (B, N, S, C)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if pos_bias is not None:
            logits = logits + pos_bias.float()
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :].bool(),
                                        torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, s, n * c)
        return self.o(out)


class T5FeedForward(nn.Module):
    """fc2(fc1(x) * gelu(gate(x))) with the exact (erf) GELU."""

    def __init__(self, dim: int, dim_ffn: int):
        super().__init__()
        self.gate = nn.ModuleDict({"0": Linear(dim, dim_ffn, bias=False)})
        self.fc1 = Linear(dim, dim_ffn, bias=False)
        self.fc2 = Linear(dim_ffn, dim, bias=False)

    def forward(self, x):
        gate = F.gelu(self.gate["0"](x))
        return self.fc2(self.fc1(x) * gate)


class T5Block(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        self.shared_pos = config.shared_pos
        self.norm1 = LayerNorm(config.dim, bias=False)
        self.attn = T5Attention(config.dim, config.dim_attn, config.num_heads)
        self.norm2 = LayerNorm(config.dim, bias=False)
        self.ffn = T5FeedForward(config.dim, config.dim_ffn)
        if not config.shared_pos:
            self.pos_embedding = T5RelativeEmbedding(config.num_buckets, config.num_heads)

    def forward(self, x, mask=None, pos_bias=None):
        if not self.shared_pos:
            pos_bias = self.pos_embedding(x.shape[1], x.shape[1])
        x = x + self.attn(self.norm1(x), mask=mask, pos_bias=pos_bias)
        return x + self.ffn(self.norm2(x))


class T5Encoder(nn.Module):
    def __init__(self, config: TextEncoderConfig):
        super().__init__()
        self.config = config
        self.token_embedding = Embedding(config.vocab_size, config.dim)
        if config.shared_pos:
            self.pos_embedding = T5RelativeEmbedding(config.num_buckets, config.num_heads)
        self.blocks = nn.ModuleList([T5Block(config) for _ in range(config.num_layers)])
        self.norm = LayerNorm(config.dim, bias=False)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.token_embedding(input_ids)
        pos_bias = (self.pos_embedding(x.shape[1], x.shape[1])
                    if self.config.shared_pos else None)
        for block in self.blocks:
            x = block(x, mask=attention_mask, pos_bias=pos_bias)
        return self.norm(x)


def tokenize_prompts(tokenizer, prompts: list[str], max_token_length: int):
    """(ids, mask), (N, L) int32 numpy each: "longest" padding, rows a
    tokenizer leaves unequal padded to the longest on its ``padding_side``
    ("right" where it names none) with its ``pad_token_id`` (0 without
    one). The mask is the tokenizer's where it gives one (padded with 0),
    else ``ids != pad_token_id``."""
    out = tokenizer(prompts, max_length=max_token_length, padding="longest",
                    truncation=True, add_special_tokens=True)
    rows = [list(row) for row in out["input_ids"]]
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    left = getattr(tokenizer, "padding_side", "right") == "left"
    longest = max(len(row) for row in rows)

    def pad(row, value):
        fill = [value] * (longest - len(row))
        return fill + row if left else row + fill

    ids = np.asarray([pad(row, pad_id) for row in rows], np.int32)
    if "attention_mask" in out:
        mask = np.asarray([pad(list(row), 0) for row in out["attention_mask"]], np.int32)
    else:
        mask = (ids != pad_id).astype(np.int32)
    return ids, mask


class TextEncoder(nn.Module):
    """Tokenizer and encoder; the encoder sits under ``model.``."""

    def __init__(self, config: Optional[TextEncoderConfig] = None, tokenizer=None):
        super().__init__()
        self.model = T5Encoder(config or TextEncoderConfig())
        self.tokenizer = tokenizer

    def encode_tokens(self, input_ids: torch.Tensor,
                      attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model(input_ids, attention_mask)

    def normalize_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = True,
    ) -> tuple[list[str], list[str]]:
        _prompts = list(prompts) if isinstance(prompts, (list, tuple)) else [prompts]
        if not use_negative_prompts:
            _negatives = []
        elif negative_prompts is None:
            _negatives = [""] * len(_prompts)
        else:
            _negatives = (
                list(negative_prompts)
                if isinstance(negative_prompts, (list, tuple))
                else [negative_prompts]
            )
            if len(_negatives) == 1 and len(_prompts) > 1:
                _negatives = _negatives * len(_prompts)
        return _prompts, _negatives

    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = False,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
    ) -> TextEncodingOutput:
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured for TextEncoder")
        _prompts, _negatives = self.normalize_prompts(
            prompts, negative_prompts, use_negative_prompts
        )
        n_pos = len(_prompts)
        ids, mask = tokenize_prompts(self.tokenizer, _prompts + _negatives, max_token_length)
        device = self.model.token_embedding.weight.device
        ids = torch.from_numpy(ids).long().to(device)
        mask = torch.from_numpy(mask).to(device)
        hidden = self.encode_tokens(ids, mask)
        return TextEncodingOutput(
            positive_embeddings=hidden[:n_pos],
            positive_attention_mask=mask[:n_pos],
            negative_embeddings=hidden[n_pos:],
            negative_attention_mask=mask[n_pos:],
        )
