"""Fused LayerNorm forward: wrapper and plain version.

Counterpart of ``vision_ft_tpu/ops/pallas/layer_norm.py::layer_norm_tpu``
(forward only; the port has no training path yet). The kernel is the
Triton source ``csrc/layer_norm.py``.

- :func:`layer_norm_reference` is the plain PyTorch formula, the JAX
  ``nn.LayerNorm`` formula (fp32 mean and variance, ``rsqrt(var + eps)``,
  x gamma (+ beta), cast back).
- :func:`layer_norm` is the wrapper. For a CPU tensor it returns the
  plain version. For a CUDA tensor it launches the kernel or raises; it
  counts its launches in ``layer_norm.launches``.

Layout: x is (..., C), normalized over the last axis; gamma and beta (C,).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_MAX_C = 8192


def layer_norm_reference(
    x: torch.Tensor,
    weight: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    eps: float = 1e-5,
) -> torch.Tensor:
    h = x.float()
    mean = h.mean(dim=-1, keepdim=True)
    var = (h - mean).square().mean(dim=-1, keepdim=True)
    h = (h - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        h = h * weight.float()
    if bias is not None:
        h = h + bias.float()
    return h.to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    c = x.shape[-1] if x.ndim else 0
    if x.ndim < 1 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            f"layer_norm kernel takes a contiguous bf16 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if not 0 < c <= _MAX_C:
        raise ValueError(f"layer_norm kernel takes 1 <= C <= {_MAX_C}, got {c}")
    for t in (weight, bias) if bias is not None else (weight,):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"layer_norm kernel needs contiguous ({c},) affine on {x.device}")


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (bf16 on the card) with
    affine ``weight`` (required) and optional ``bias``; returns x's dtype."""
    if not x.is_cuda:
        return layer_norm_reference(x, weight, bias, eps)
    _check(x, weight, bias)
    kernels = _build.triton_module("layer_norm")
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    if rows:
        block_c = 1 << (c - 1).bit_length()
        kernels.layer_norm_fwd_kernel[(rows,)](
            x, weight, bias if bias is not None else weight, y,
            c, c, c, eps,
            HAS_BIAS=bias is not None,
            BLOCK_C=block_c,
            num_warps=4 if block_c <= 2048 else 8,
        )
        layer_norm.launches += 1
    return y


layer_norm.launches = 0
