"""Attention dispatch (``vision_ft_tpu/ops/attention.py`` counterpart).

Layouts: :func:`scaled_dot_product_attention` takes (B, H, S, D);
:func:`attention_heads_packed` takes heads-packed (B, S, H*D).

Which path runs:

- :func:`attention_heads_packed` sends CUDA tensors to the BSHD flash
  kernel (``ops/flash_attention.py``) on a flash backend when there is no
  mask, no causal masking, sk >= 256 and a head dim the kernel takes; the
  SDXL UNet self-attentions are such calls. Everything else splits the
  heads with views and goes through :func:`scaled_dot_product_attention`.
- :func:`scaled_dot_product_attention` sends a flash backend to
  ``ops.flash_attention.flash_attention``: on the card, sk >= 256 with no
  mask or a boolean key mask goes to the key-masked (B, H, S, D) kernel
  (the Lumina2 NextDiT blocks are such calls); with
  ``ops.flash_attention.set_flash_shortk(True)``, at most 192 keys with no
  mask and no causal masking go to the short-K kernels (SDXL's 77-key
  cross-attention); other shorter keys (CLIP), other masks and CPU tensors
  take the plain formula, as does the "xla" backend (VAE). k and v may
  carry fewer heads than q (grouped-query attention): the kernel maps the
  heads itself, the plain formula repeats them.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from .flash_attention import _expand_kv_heads, flash_attention, flash_attention_bshd, supports

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
    additive float, broadcastable to (B, H, Sq, Sk). k and v have q's
    head count or a divisor of it."""
    _check_backend(backend)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if backend in _FLASH_BACKENDS:
        return flash_attention(q, k, v, mask=mask, scale=scale, is_causal=is_causal)
    h = q.shape[1]
    return plain_attention(q, _expand_kv_heads(k, h), _expand_kv_heads(v, h), mask, scale, is_causal)


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

    out = scaled_dot_product_attention(
        heads(q), heads(k), heads(v), mask=mask, scale=scale, backend=backend,
        is_causal=is_causal,
    )
    return out.transpose(1, 2).reshape(b, s, inner)
