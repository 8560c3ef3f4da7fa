"""Fused LayerNorm: wrapper, launch plan, plain version and backward.

Counterpart of ``vision_ft_tpu/ops/pallas/layer_norm.py::layer_norm_tpu``
and its custom VJP. The forward is one launch of the CUDA C++ kernel
``csrc/layer_norm.cu`` (kernel A, built for ``sm_90a`` by ``ops/_build.py``
and bound with ``ctypes``); the backward is, as in the JAX package, a plain
formula outside any kernel.

- :func:`layer_norm_reference` is the plain PyTorch formula, the JAX
  ``nn.LayerNorm`` formula (fp32 mean and variance, ``rsqrt(var + eps)``,
  x gamma (+ beta), cast back).
- :func:`layer_norm_backward` is the JAX ``_layer_norm_bwd`` formula: fp32,
  from (x, gamma, beta) only (the statistics are recomputed), dgamma and
  dbeta summed over all leading axes.
- :func:`ln_plan` is the kernel's launch plan, a pure function of the rows,
  C and the SM count.
- :func:`layer_norm` is the wrapper. For a CPU tensor its forward is the
  plain version. For a CUDA tensor it launches the kernel or raises
  ``ValueError`` (x not bf16, C outside 1 to 8192, a last axis that is not
  contiguous or leading axes that do not fold into a batch axis and a row
  axis, gamma or beta not a (C,) bf16 / fp32 tensor on x's card) or
  ``RuntimeError`` (a launch the card refuses); it counts its launches in
  ``layer_norm.launches``. Its host path is the checks, one ``torch.empty``
  and one ``ctypes`` call on PyTorch's current stream. When gradients are
  wanted it goes through a ``torch.autograd.Function`` that keeps
  (x, gamma, beta) and whose backward is :func:`layer_norm_backward`.

Layout: x is (..., C), normalized over the last axis; gamma and beta (C,).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build

_MAX_C = 8192
_WARPS = 4           # kernel A's block: 4 warps, 128 threads
_MAX_VPL = 8         # vectors of 8 elements a lane holds (ptxas: no spill at 8, bf16 affine)
_BLOCKS_PER_SM = 16  # 128-thread blocks an SM's 2048 threads hold; the C entry trims the grid
#                      to what the kernel's registers let reside


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


class LnPlan(NamedTuple):
    warps_per_row: int     # 1, 2 or 4 warps share a row
    vectors_per_lane: int  # vectors of 8 elements a lane holds in registers, 1 to 8
    rows_per_block: int    # rows a block takes at a time: 4 // warps_per_row
    blocks: int            # the persistent grid, at most the SMs' worth of resident blocks


@functools.lru_cache(maxsize=1024)
def ln_plan(rows: int, c: int, sms: int) -> LnPlan:
    """Kernel A's launch plan: the fewest warps a row (1, 2 or 4) whose
    lanes hold the row's ceil(C / 8) vectors at 8 or fewer vectors a lane,
    and a grid of one block a group of rows, at most 16 an SM. A function
    of the shape and the card alone."""
    vectors = -(-c // 8)
    warps = 1
    while warps * 32 * _MAX_VPL < vectors:
        warps *= 2
    per_block = _WARPS // warps
    return LnPlan(warps, -(-vectors // (32 * warps)), per_block,
                  min(-(-rows // per_block), sms * _BLOCKS_PER_SM))


def _row_layout(x: torch.Tensor):
    """(inner, batch_stride, row_stride) in elements with which the kernel
    reaches x's rows: row r at (r // inner) * batch_stride + (r % inner) *
    row_stride. None where the last axis is not contiguous or the leading
    axes do not fold into a batch axis and one row axis."""
    c = x.shape[-1]
    if x.is_contiguous():
        return max(1, x.numel() // c), 0, c
    if x.stride(-1) != 1 and c > 1:
        return None
    dims = [(n, s) for n, s in zip(x.shape[:-1], x.stride()[:-1]) if n != 1]
    (_, batch_stride), inner = dims[0], dims[1:]
    for (_, outer), (n, s) in zip(inner, inner[1:]):
        if outer != n * s:
            return None
    return math.prod(n for n, _ in inner), batch_stride, inner[-1][1] if inner else c


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """The kernel's contract, but for x's row layout (:func:`_row_layout`)."""
    c = x.shape[-1] if x.ndim else 0
    if x.dtype != torch.bfloat16 or not 0 < c <= _MAX_C:
        raise ValueError(f"layer_norm kernel takes a bf16 tensor of 1 <= C <= {_MAX_C}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    index, dtype = x.get_device(), weight.dtype
    for t in (weight,) if bias is None else (weight, bias):
        if (t.shape != (c,) or t.dtype != dtype or t.get_device() != index
                or not t.is_contiguous()):
            raise ValueError(f"layer_norm kernel needs contiguous ({c},) gamma and beta of one "
                             f"dtype on {x.device}, got {t.dtype} {tuple(t.shape)}")
    if dtype != torch.bfloat16 and dtype != torch.float32:
        raise ValueError(f"layer_norm kernel takes bf16 or fp32 gamma and beta, got {dtype}")


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


@functools.cache
def _kernels():
    """(contiguous rows, strided rows) C entries of ``csrc/layer_norm.cu``."""
    lib = _build.cuda_library("layer_norm")
    rows = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
    tail = [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.layer_norm_fwd.argtypes = rows + tail
    lib.layer_norm_fwd_strided.argtypes = rows + [ctypes.c_longlong] * 3 + tail
    for fn in (lib.layer_norm_fwd, lib.layer_norm_fwd_strided):
        fn.restype = ctypes.c_int
    return lib.layer_norm_fwd, lib.layer_norm_fwd_strided


def _forward(x, weight, bias, eps):
    if not x.is_cuda:
        return layer_norm_reference(x, weight, bias, eps)
    _check(x, weight, bias)
    c = x.shape[-1]
    contiguous = x.is_contiguous()
    layout = None if contiguous else _row_layout(x)
    if not contiguous and layout is None:
        raise ValueError(f"layer_norm kernel takes x whose last axis is contiguous and whose "
                         f"leading axes fold into a batch axis and a row axis, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    y = torch.empty_like(x) if contiguous else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x.numel() // c
    if not rows:
        return y
    index = x.get_device()
    plan = ln_plan(rows, c, _build.sm_count(index))
    x_ptr, y_ptr, w_ptr = x.data_ptr(), y.data_ptr(), weight.data_ptr()
    b_ptr = 0 if bias is None else bias.data_ptr()
    strides = 0 if contiguous else layout[1] | layout[2]
    # the C entry's launch word: 16-byte accesses, fp32 affine, warps a row, vectors a
    # lane, blocks
    vec = (x_ptr | y_ptr | w_ptr | b_ptr | 2 * (c | strides)) % 16 == 0
    word = (plan.blocks << 9 | plan.vectors_per_lane << 5 | plan.warps_per_row << 2
            | (weight.dtype == torch.float32) << 1 | vec)
    if contiguous:
        err = _build.launch(_kernels()[0], index, x_ptr, y_ptr, w_ptr, b_ptr, rows, c, word, eps)
    else:
        err = _build.launch(_kernels()[1], index, x_ptr, y_ptr, w_ptr, b_ptr, rows, c, *layout,
                            word, eps)
    if err != 0:
        raise RuntimeError(f"layer_norm launch failed: CUDA error {err}")
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
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias is not None and bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps)


layer_norm.launches = 0
