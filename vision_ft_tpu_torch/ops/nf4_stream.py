"""Panel-streamed NF4 matmul (``vision_ft_tpu/ops/nf4_stream.py``
counterpart): plain dequantization at bounded memory.

A Python loop over N-panels of the packed weight. Each iteration
dequantizes ONE (bn, k) panel with the plain ``dequantize_4bit`` (the only
weight-sized temporary alive) and multiplies it with ``torch.matmul``,
writing its columns into one preallocated output. Every weight element is
dequantized once a call, and the peak weight temporary is one panel.

Backward (QLoRA: base frozen, dx only): the hand-written dx kernel of
``ops/nf4_matmul.py`` where its contract holds (bf16 on the card, a shape
its ``supports`` accepts), so the weight stays packed; else the same panel
loop. No part of this route is a kernel of its own: the JAX package leaves
it to XLA outside any Pallas kernel, and so it is plain PyTorch here.
"""

from __future__ import annotations

import torch

from ..modules.quant.nf4 import dequantize_4bit
from . import nf4_matmul as fused

# target panel footprint in bytes of the dequantized (bn, k) panel at two
# bytes an element, the JAX package's default
_PANEL_BYTES = 32 * 1024 * 1024


def pick_panel(n: int, k: int) -> int:
    """Rows of one panel: a multiple of 128 that divides ``n`` and keeps the
    panel near ``_PANEL_BYTES``; the whole of ``n`` where ``n`` is no
    multiple of 128 (decided before the search, which needs one)."""
    if n % 128:
        return n
    bn = max(128, min(n, _PANEL_BYTES // max(1, 2 * k) // 128 * 128))
    while n % bn:
        bn -= 128
    return bn


def supports(n: int, k: int, blocksize: int) -> bool:
    """The fused kernels' contract, minus their constraint on k beyond
    whole blocks."""
    return n % 128 == 0 and k % 2 == 0 and blocksize == 64 and k % blocksize == 0


def _panels(packed2, absmax2, code, blocksize, dtype):
    """Yield (first row, rows, dequantized (rows, k) panel)."""
    n, k = packed2.shape[0], packed2.shape[1] * 2
    bn = pick_panel(n, k)
    for start in range(0, n, bn):
        rows = min(bn, n - start)
        panel = dequantize_4bit(
            packed2[start:start + rows], code, absmax2[start:start + rows].reshape(-1),
            (rows, k), blocksize, dtype, split=True,
        )
        yield start, rows, panel


def _forward(x2, packed2, absmax2, code, blocksize):
    out = torch.empty((x2.shape[0], packed2.shape[0]), device=x2.device, dtype=x2.dtype)
    for start, rows, panel in _panels(packed2, absmax2, code, blocksize, x2.dtype):
        torch.matmul(x2, panel.t(), out=out[:, start:start + rows])
    return out


def _backward(dy2, packed2, absmax2, code, blocksize):
    n, k = packed2.shape[0], packed2.shape[1] * 2
    if dy2.is_cuda and dy2.dtype == torch.bfloat16 and fused.supports(dy2.shape[0], k, n, blocksize):
        return fused.nf4_matmul_dx(
            dy2.contiguous(), packed2, code, absmax2.reshape(-1), (n, k), blocksize, split=True
        )
    dx = torch.zeros((dy2.shape[0], k), device=dy2.device, dtype=torch.float32)
    for start, rows, panel in _panels(packed2, absmax2, code, blocksize, dy2.dtype):
        dx += torch.matmul(dy2[:, start:start + rows], panel).float()
    return dx.to(dy2.dtype)


class _NF4Stream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, packed2, absmax2, code, blocksize):
        ctx.save_for_backward(packed2, absmax2, code)
        ctx.meta = (blocksize, x2.dtype)
        return _forward(x2, packed2, absmax2, code, blocksize)

    @staticmethod
    def backward(ctx, dy):
        packed2, absmax2, code = ctx.saved_tensors
        blocksize, dtype = ctx.meta
        return _backward(dy.to(dtype), packed2, absmax2, code, blocksize), None, None, None, None


def nf4_stream_matmul(
    x: torch.Tensor,
    packed: torch.Tensor,
    code: torch.Tensor,
    absmax: torch.Tensor,
    shape: tuple[int, int],
    blocksize: int = 64,
) -> torch.Tensor:
    """x @ W^T with W packed split-layout NF4, dequantized panel by panel.
    Callers check :func:`supports` first; the weight must be in the split
    device layout (the canonical on-device form). Differentiable in ``x``
    only."""
    n, k = shape
    x2 = x.reshape(-1, k)
    packed2 = packed.reshape(n, k // 2)
    absmax2 = absmax.float().reshape(n, k // blocksize)
    code = code.float()
    if torch.is_grad_enabled() and x.requires_grad:
        y = _NF4Stream.apply(x2, packed2, absmax2, code, blocksize)
    else:
        y = _forward(x2, packed2, absmax2, code, blocksize)
    return y.reshape(*x.shape[:-1], n)
