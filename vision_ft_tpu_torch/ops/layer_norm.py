"""Fused LayerNorm: wrapper, plain version and backward.

Counterpart of ``vision_ft_tpu/ops/pallas/layer_norm.py::layer_norm_tpu``
and its custom VJP. The forward kernel is the Triton source
``csrc/layer_norm.py``; the backward is, as in the JAX package, a plain
formula outside any kernel.

- :func:`layer_norm_reference` is the plain PyTorch formula, the JAX
  ``nn.LayerNorm`` formula (fp32 mean and variance, ``rsqrt(var + eps)``,
  x gamma (+ beta), cast back).
- :func:`layer_norm_backward` is the JAX ``_layer_norm_bwd`` formula: fp32,
  from (x, gamma, beta) only (the statistics are recomputed), dgamma and
  dbeta summed over all leading axes.
- :func:`layer_norm` is the wrapper. For a CPU tensor its forward is the
  plain version. For a CUDA tensor it launches the kernel or raises; it
  counts its launches in ``layer_norm.launches``. When gradients are
  wanted it goes through a ``torch.autograd.Function`` that keeps
  (x, gamma, beta) and whose backward is :func:`layer_norm_backward`.

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


def layer_norm_backward(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    dy: torch.Tensor,
    eps: float = 1e-5,
    affine_grads: bool = True,
):
    """(dx, dgamma, dbeta) of LayerNorm over the last axis; dbeta is None
    without a bias, and both are None when ``affine_grads`` is off (a frozen
    affine). fp32 inside, each result in its input's dtype."""
    xf = x.float()
    g = dy.float()
    centered = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(centered.square().mean(dim=-1, keepdim=True) + eps)
    xhat = centered * rstd
    gg = g * weight.float()
    dx = rstd * (
        gg - gg.mean(dim=-1, keepdim=True) - xhat * (gg * xhat).mean(dim=-1, keepdim=True)
    )
    if not affine_grads:
        return dx.to(x.dtype), None, None
    c = x.shape[-1]
    dgamma = (g * xhat).reshape(-1, c).sum(dim=0).to(weight.dtype)
    dbeta = None if bias is None else g.reshape(-1, c).sum(dim=0).to(bias.dtype)
    return dx.to(x.dtype), dgamma, dbeta


def _forward(x, weight, bias, eps):
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


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_backward(
            x, weight, bias, dy, ctx.eps, affine_grads=any(ctx.needs_input_grad[1:3])
        )
        return dx, dgamma, dbeta, None


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (bf16 on the card) with
    affine ``weight`` (required) and optional ``bias``; returns x's dtype.
    Differentiable in x, weight and bias."""
    tensors = (x, weight) if bias is None else (x, weight, bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)


layer_norm.launches = 0
