"""SDXL RoPE retrofit (``vision_ft_tpu/models/sdxl/adapter/rope.py``
counterpart): 2-axis rotary embeddings on the pretrained UNet's
attention.

It adds no parameters: the state dict of a RoPE-retrofit model is that of
the plain SDXL UNet, so sgm checkpoints load unchanged. The retrofit's
transformer block rotates q and k in self-attention, and q and the
context's k (at diagonal (i, i) positions) in cross-attention, before the
shared attention dispatch. The frequency tables are built per (height,
width) or length in float64 on the host, cached, and moved to the
device once per device; the rotation runs in fp32.

On the card the rotated self-attention is an unmasked (B, H, S, D) call
with S >= 256, so it takes the key-masked flash kernel (kernel E) and,
in training, its backward (kernel G), at head dim 64; the cross-attention
(77 to 231 keys) takes the plain formula, as in the JAX package.

``set_rope_enabled`` / ``while_rope_enabled`` / ``while_rope_disabled``
override the config flag for every block (None restores it), as the
PEFT toggle does.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Literal, Optional

import numpy as np
import torch

from ....nn import saved_products
from ....ops.attention import scaled_dot_product_attention
from ..config import DenoiserConfig, SDXLConfig
from ..denoiser import CrossAttention, Denoiser, SelfAttention, TransformerBlock
from ..pipeline import SDXLModel

ORIGIN_POSITION = Literal["top_left", "center"]

_rope_enabled: Optional[bool] = None  # None -> the config's flag


def set_rope_enabled(enabled: Optional[bool]) -> None:
    """Global override of every RoPE block's flag (None restores the
    config default)."""
    global _rope_enabled
    _rope_enabled = enabled


@contextmanager
def _rope_override(value: bool):
    global _rope_enabled
    previous, _rope_enabled = _rope_enabled, value
    try:
        yield
    finally:
        _rope_enabled = previous


def while_rope_enabled():
    return _rope_override(True)


def while_rope_disabled():
    return _rope_override(False)


def _axis_freqs(position_ids: np.ndarray, dim: int, theta: float) -> np.ndarray:
    """Angles (float64) for one axis: radians[s, j] = pos[s] / theta^(2j/dim)."""
    exponent = np.arange(0, dim, 2, dtype=np.float64) / dim
    inv = 1.0 / np.power(theta, exponent)
    return position_ids.astype(np.float64)[:, None] * inv[None, :]


class RoPEEmbedder:
    """cos / sin tables, cached per shape on the host and per (shape,
    device) as tensors."""

    def __init__(
        self,
        rope_dims: tuple[int, ...] = (32, 32),
        rope_theta: float = 10000.0,
        origin_position: ORIGIN_POSITION = "top_left",
    ):
        self.rope_dims = tuple(rope_dims)
        self.rope_theta = rope_theta
        self.origin_position = origin_position
        self._tables: dict = {}

    def _angles(self, y: np.ndarray, x: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [
                _axis_freqs(y, self.rope_dims[0], self.rope_theta),
                _axis_freqs(x, self.rope_dims[1], self.rope_theta),
            ],
            axis=1,
        )

    def _table(self, key, angles_fn, device):
        if key not in self._tables:
            angles = angles_fn()
            self._tables[key] = (np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32))
        device_key = (key, str(device))
        if device_key not in self._tables:
            cos, sin = self._tables[key]
            self._tables[device_key] = (
                torch.from_numpy(cos).to(device or "cpu"), torch.from_numpy(sin).to(device or "cpu")
            )
        return self._tables[device_key]

    def image_freqs(self, height: int, width: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """(H*W, sum(dims)//2) cos / sin of the y / x token grid."""

        def angles():
            y = np.repeat(np.arange(height, dtype=np.int64), width)
            x = np.tile(np.arange(width, dtype=np.int64), height)
            if self.origin_position == "center":
                # math.ceil(h // 2) == h // 2, as in the JAX package
                y = y - math.ceil(height // 2)
                x = x - math.ceil(width // 2)
            return self._angles(y, x)

        return self._table(("image", height, width), angles, device)

    def context_freqs(self, length: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Diagonal (i, i) positions for the text tokens."""

        def angles():
            ids = np.arange(length, dtype=np.int64)
            return self._angles(ids, ids)

        return self._table(("context", length), angles, device)


def apply_rope(x: torch.Tensor, freqs: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Interleaved-pair rotation in fp32 (a complex multiply on (even, odd)
    pairs). x: (B, H, S, D); freqs: cos / sin (S, D // 2)."""
    cos, sin = freqs
    b, h, s, d = x.shape
    xf = x.float().reshape(b, h, s, d // 2, 2)
    even, odd = xf[..., 0], xf[..., 1]
    out = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return out.reshape(b, h, s, d).to(x.dtype)


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, s, inner = t.shape
    return t.reshape(b, s, h, inner // h).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


class SelfAttentionWithRoPE(SelfAttention):
    """Without tables (RoPE off) it is the base attention over heads-packed
    tensors (kernel B on the card); with them the rotated q and k go
    through the (B, H, S, D) dispatch (kernels E and G)."""

    @saved_products()
    def forward(self, x, image_freqs=None, **_):
        if image_freqs is None:
            return super().forward(x)
        h = self.num_heads
        q = apply_rope(_heads(self["to_q"](x), h), image_freqs)
        k = apply_rope(_heads(self["to_k"](x), h), image_freqs)
        v = _heads(self["to_v"](x), h)
        attn = scaled_dot_product_attention(q, k, v, backend=self.backend)
        return self["to_out"]["0"](_merge(attn))


class CrossAttentionWithRoPE(CrossAttention):
    @saved_products()
    def forward(self, x, context, image_freqs=None, context_freqs=None, **_):
        if image_freqs is None:
            return super().forward(x, context)
        h = self.num_heads
        q = apply_rope(_heads(self["to_q"](x), h), image_freqs)
        k = apply_rope(_heads(self["to_k"](context), h), context_freqs)
        v = _heads(self["to_v"](context), h)
        attn = scaled_dot_product_attention(q, k, v, backend=self.backend)
        return self["to_out"]["0"](_merge(attn))


class TransformerBlockWithRoPE(TransformerBlock):
    """The block with both attentions rotary (the same parameter keys);
    it looks up its feature map's tables in the embedder all blocks
    share."""

    def __init__(
        self,
        hidden_dim: int,
        num_heads: int,
        head_dim: int,
        context_dim: int,
        backend,
        cross_attention_class: Optional[type] = None,
        cross_attention_extra: Optional[dict] = None,
        rope_embedder: Optional[RoPEEmbedder] = None,
        rope_enabled: bool = True,
    ):
        super().__init__(
            hidden_dim, num_heads, head_dim, context_dim, backend,
            cross_attention_class, cross_attention_extra,
        )
        self["attn1"] = SelfAttentionWithRoPE(num_heads, head_dim, backend)
        if cross_attention_class is None:
            self["attn2"] = CrossAttentionWithRoPE(
                hidden_dim, context_dim, num_heads, head_dim, backend
            )
        self.rope_embedder = rope_embedder or RoPEEmbedder()
        self.rope_enabled = rope_enabled

    def _enabled(self) -> bool:
        return self.rope_enabled if _rope_enabled is None else _rope_enabled

    def forward(self, x, context, cross_attention_kwargs=None, hw=None):
        kwargs = dict(cross_attention_kwargs or {})
        image_freqs = context_freqs = None
        if self._enabled():
            if hw is None:
                raise ValueError("the feature map's hw is needed for RoPE")
            image_freqs = self.rope_embedder.image_freqs(*hw, device=x.device)
            context_freqs = self.rope_embedder.context_freqs(context.shape[1], device=x.device)
        x = x + self["attn1"](self["norm1"](x), image_freqs=image_freqs)
        x = x + self["attn2"](
            self["norm2"](x), context, image_freqs=image_freqs, context_freqs=context_freqs,
            **kwargs,
        )
        return x + self["ff"](self["norm3"](x))


class DenoiserConfigWithRoPE(DenoiserConfig):
    rope_enabled: bool = True
    migrating: bool = False

    rope_dims: list[int] = [32, 32]
    rope_theta: float = 10000.0
    origin_position: ORIGIN_POSITION = "center"


class DenoiserWithRoPE(Denoiser):
    def __init__(self, config: DenoiserConfigWithRoPE):
        self.rope_embedder = RoPEEmbedder(
            rope_dims=tuple(config.rope_dims),
            rope_theta=config.rope_theta,
            origin_position=config.origin_position,
        )
        # the shared embedder and the flag go to every transformer block
        self.transformer_block_class = TransformerBlockWithRoPE
        self.transformer_block_extra = {
            "rope_embedder": self.rope_embedder,
            "rope_enabled": config.rope_enabled,
        }
        super().__init__(config)
        self.rope_enabled = config.rope_enabled

    def set_rope_enabled(self, enabled: bool) -> None:
        """Set the flag of every block."""
        self.rope_enabled = enabled
        for module in self.modules():
            if isinstance(module, TransformerBlockWithRoPE):
                module.rope_enabled = enabled


class SDXLWithRoPEConfig(SDXLConfig):
    denoiser: DenoiserConfigWithRoPE = DenoiserConfigWithRoPE()


class SDXLWithRoPEModel(SDXLModel):
    """No extra parameters: checkpoints are plain SDXL sgm state dicts."""

    denoiser_class = DenoiserWithRoPE

    @classmethod
    def from_config(cls, config: SDXLWithRoPEConfig, **kwargs) -> "SDXLWithRoPEModel":
        return cls(config, **kwargs)
