"""Attention dispatch (``vision_ft_tpu/ops/attention.py`` counterpart).

Layouts: :func:`scaled_dot_product_attention` takes (B, H, S, D);
:func:`attention_heads_packed` takes heads-packed (B, S, H*D).

Which path runs:

- :func:`attention_heads_packed` sends CUDA tensors to the BSHD flash
  kernel (``ops/flash_attention.py``) on a flash backend when there is no
  mask, no causal masking, sk >= 256 and a head dim the kernel takes; the
  SDXL UNet self-attentions are such calls. Everything else splits the
  heads with views and runs the plain formula.
- :func:`scaled_dot_product_attention` runs the plain formula for every
  backend. The JAX package's BHSD and short-key Pallas kernels are not
  ported yet (ROADMAP.md), and on the SDXL generate path every call here
  has sk < 256 (77-key cross attention, CLIP) or the "xla" backend (VAE),
  where the JAX package runs plain XLA too.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from .flash_attention import flash_attention_bshd, supports

AttentionImplementation = Literal[
    "xla",
    "flash",
    "flash_attention",
    "eager",
    "sdpa",
    "flash_attention_2",
    "xformers",
]

_FLASH_BACKENDS = {"flash", "flash_attention", "flash_attention_2", "xformers"}
_XLA_BACKENDS = {"xla", "eager", "sdpa"}


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    scale: float,
    is_causal: bool,
) -> torch.Tensor:
    """The JAX ``_xla_attention`` formula over (B, H, S, D): fp32 scores,
    softmax, weights cast to v's dtype; fully-masked rows give 0."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if is_causal:
        q_len, k_len = logits.shape[-2:]
        causal = torch.ones(q_len, k_len, dtype=torch.bool, device=q.device).tril(k_len - q_len)
        logits = logits.masked_fill(~causal, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, float("-inf"))
        else:
            logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    weights = torch.nan_to_num(weights, nan=0.0).to(v.dtype)
    return torch.matmul(weights, v)


def _check_backend(backend: str) -> None:
    if backend not in _FLASH_BACKENDS and backend not in _XLA_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: AttentionImplementation = "xla",
    is_causal: bool = False,
) -> torch.Tensor:
    """Attention over (B, H, S, D). ``mask``: bool (True = attend) or
    additive float, broadcastable to (B, H, Sq, Sk)."""
    _check_backend(backend)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return plain_attention(q, k, v, mask, scale, is_causal)


def attention_heads_packed(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    backend: AttentionImplementation = "xla",
    is_causal: bool = False,
) -> torch.Tensor:
    """Attention over heads-packed (B, S, H*D) tensors, the layout the
    q/k/v projections produce."""
    _check_backend(backend)
    b, s, inner = q.shape
    d = inner // num_heads
    if scale is None:
        scale = d**-0.5
    if (
        q.is_cuda
        and backend in _FLASH_BACKENDS
        and mask is None
        and not is_causal
        and k.shape[1] >= 256
        and supports(num_heads, d)
    ):
        return flash_attention_bshd(q, k, v, num_heads, scale=scale)

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2)

    out = plain_attention(heads(q), heads(k), heads(v), mask, scale, is_causal)
    return out.transpose(1, 2).reshape(b, s, inner)
