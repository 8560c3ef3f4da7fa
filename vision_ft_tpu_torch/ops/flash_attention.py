"""BSHD flash attention forward: wrapper and plain version.

Counterpart of ``vision_ft_tpu/ops/pallas/flash_attention.py::
flash_attention_bshd`` (forward). The kernel is the CUDA C++ source
``csrc/flash_attention_bshd.cu``, built for ``sm_90a`` by
``ops/_build.py`` and bound with ``ctypes``.

Layout: q (B, Sq, H*D), k and v (B, Sk, H*D), heads packed along the
last axis (head h is columns [h*D, (h+1)*D)); the output has q's shape
and dtype.

- :func:`flash_attention_bshd_reference` is the plain PyTorch version:
  the heads are split by views and the JAX package's plain attention
  formula (fp32 scores, softmax, weights cast to v's dtype) runs on them.
- :func:`flash_attention_bshd` is the wrapper. For a CPU tensor it
  returns the plain version. For a CUDA tensor it launches the kernel or
  raises; it counts its launches in ``flash_attention_bshd.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

SUPPORTED_HEAD_DIMS = (64, 128)


def flash_attention_bshd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    from .attention import plain_attention

    b, sq, inner = q.shape
    d = inner // num_heads
    scale = d**-0.5 if scale is None else scale

    def heads(t):
        return t.reshape(b, t.shape[1], num_heads, d).transpose(1, 2)

    out = plain_attention(heads(q), heads(k), heads(v), None, scale, False)
    return out.transpose(1, 2).reshape(b, sq, inner)


@functools.cache
def _kernel():
    fn = _build.cuda_library("flash_attention_bshd").flash_attention_bshd_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 8
        + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def supports(num_heads: int, head_dim: int) -> bool:
    """Whether the kernel takes this head layout."""
    return num_heads > 0 and head_dim in SUPPORTED_HEAD_DIMS


def _check(q, k, v, num_heads) -> int:
    b, sq, inner = q.shape
    if inner % num_heads or not supports(num_heads, inner // num_heads):
        raise ValueError(
            f"flash_attention_bshd kernel takes head dims {SUPPORTED_HEAD_DIMS}, "
            f"got {inner} columns over {num_heads} heads"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bf16 on {q.device}, got {t.dtype} on {t.device}")
        if t.ndim != 3 or t.shape[0] != b or t.shape[2] != inner:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected (B, S, {inner})")
        # 16-byte vector loads: unit last stride, 8-element row strides
        if t.stride(2) != 1 or t.stride(1) % 8 or t.stride(0) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last axis and 16-byte aligned rows")
    if k.shape[1] != v.shape[1] or min(sq, k.shape[1]) < 1:
        raise ValueError(f"need sq >= 1 and one k/v length >= 1, got {sq}, {k.shape[1]}, {v.shape[1]}")
    if max(q.shape[1], k.shape[1]) >= 2**31 or b >= 2**16 or num_heads >= 2**16:
        raise ValueError("shape beyond the kernel's grid or int32 row index")
    return inner // num_heads


def flash_attention_bshd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q k^T * scale) v per head over heads-packed tensors.

    With ``return_lse`` (CUDA only) also returns the fp32 log-sum-exp of
    the scaled scores as (B, H, Sq), for a later backward."""
    if not q.is_cuda:
        if return_lse:
            raise ValueError("return_lse is produced by the CUDA kernel only")
        return flash_attention_bshd_reference(q, k, v, num_heads, scale)
    d = _check(q, k, v, num_heads)
    scale = d**-0.5 if scale is None else scale
    b, sq, _ = q.shape
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (
        torch.empty((b, num_heads, sq), device=q.device, dtype=torch.float32)
        if return_lse else None
    )
    kernel = _kernel()
    with torch.cuda.device(q.device):
        err = kernel(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, sq, k.shape[1], num_heads, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_bshd launch failed: CUDA error {err}")
    flash_attention_bshd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_bshd.launches = 0
