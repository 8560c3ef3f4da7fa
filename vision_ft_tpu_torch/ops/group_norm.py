"""Fused GroupNorm (+ optional SiLU): wrapper, gate, plain version and backward.

Counterpart of ``vision_ft_tpu/ops/pallas/group_norm.py::group_norm_tpu``,
its custom VJP and its gate ``supported``. As there, the op is available
and no model path calls it: ``nn.core.GroupNorm`` keeps its own formula.
The forward kernels are the Triton source ``csrc/group_norm.py`` (a
statistics pass and a normalize pass); the backward is, as in the JAX
package, a plain formula outside any kernel.

- :func:`group_norm_reference` is the plain PyTorch version, the JAX
  ``_gn_fwd_impl`` formula: fp32 per-channel sums and sums of squares over
  the spatial rows, the group mean and ``var = E[x^2] - mean^2`` from
  them, ``rsqrt(var + eps)``, the affine, the optional SiLU, cast to x's
  dtype.
- :func:`group_norm_backward` is the JAX ``_gn_bwd`` formula: fp32, the
  statistics recomputed from x, dgamma and dbeta in their own dtypes.
- :func:`supported` is the JAX gate, kept as a copy (pure shape logic).
- :func:`group_norm` is the wrapper. For a CPU tensor its forward is the
  plain version. For a CUDA tensor it launches the two kernels or raises
  ``ValueError`` (a dtype other than bf16 / fp32, a non-contiguous x, a
  shape the gate rejects, an unknown ``act``); it counts its calls that
  launch them in ``group_norm.launches``. When gradients are wanted it goes
  through a ``torch.autograd.Function`` that keeps (x, gamma, beta) and
  whose backward is :func:`group_norm_backward`.

Layout: x is (B, ..., C), seen as (B, S, C) with S the product of the
middle axes; gamma and beta are (C,).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_ACTS = (None, "silu")
# the statistics kernel: rows a step and the programs it aims for (about
# four a streaming multiprocessor of an H100), from which the number of
# parts S is split into follows; the normalize kernel's rows a program
_STATS_ROWS, _STATS_PROGRAMS, _NORM_ROWS = 32, 528, 64


def _pick_block(rows: int, target: int = 512) -> int:
    bs = target
    while rows % bs != 0 and bs > 8:
        bs //= 2
    return bs if rows % bs == 0 else 0


def supported(x, num_groups: int) -> bool:
    """The JAX gate: rank >= 3, channels divisible into groups, at least 8
    spatial rows and a row count with a power-of-two divisor in [8, 512].
    ``x`` is anything with a ``shape``."""
    shape = tuple(x.shape)
    if len(shape) < 3:
        return False
    b, c = shape[0], shape[-1]
    s = 1
    for n in shape[1:-1]:
        s *= n
    if c % num_groups != 0 or s < 8:
        return False
    return _pick_block(s) != 0


def _dims(x: torch.Tensor) -> tuple[int, int, int]:
    b, c = x.shape[0], x.shape[-1]
    return b, x.numel() // (b * c), c


def _group_moments(sum_c, sumsq_c, s, num_groups, eps):
    """Per-channel (B, C) fp32 sums -> per-channel (B, C) mean and rstd of
    each channel's group (``_gn_fwd_impl`` lines 88-97)."""
    b, c = sum_c.shape
    cg = c // num_groups
    count = s * cg
    mean_g = sum_c.reshape(b, num_groups, cg).sum(-1) / count
    var_g = sumsq_c.reshape(b, num_groups, cg).sum(-1) / count - mean_g.square()
    rstd_g = torch.rsqrt(var_g + eps)
    return mean_g.repeat_interleave(cg, dim=-1), rstd_g.repeat_interleave(cg, dim=-1)


def group_norm_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    b, s, c = _dims(x)
    xf = x.reshape(b, s, c).float()
    mean_c, rstd_c = _group_moments(xf.sum(1), xf.square().sum(1), s, num_groups, eps)
    out = (xf - mean_c[:, None, :]) * rstd_c[:, None, :]
    out = out * gamma.float() + beta.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    return out.to(x.dtype).reshape(x.shape)


def group_norm_backward(x, gamma, beta, dy, num_groups: int, eps: float, act: Optional[str] = None):
    """(dx, dgamma, dbeta) of :func:`group_norm_reference`, fp32 inside,
    each in its input's dtype."""
    b, s, c = _dims(x)
    g = num_groups
    cg = c // g
    count = s * cg
    xf = x.float().reshape(b, s, c)
    dyf = dy.float().reshape(b, s, c)
    mean_c, rstd_c = _group_moments(xf.sum(1), xf.square().sum(1), s, g, eps)
    mean_c, rstd_c = mean_c[:, None, :], rstd_c[:, None, :]
    xhat = (xf - mean_c) * rstd_c
    gam = gamma.float()
    if act == "silu":
        y = xhat * gam + beta.float()
        sig = torch.sigmoid(y)
        dyf = dyf * (sig * (1.0 + y * (1.0 - sig)))
    dgamma = (dyf * xhat).sum((0, 1)).to(gamma.dtype)
    dbeta = dyf.sum((0, 1)).to(beta.dtype)
    dxhat = dyf * gam
    m1 = dxhat.reshape(b, s, g, cg).sum((1, 3)) / count
    m2 = (dxhat * xhat).reshape(b, s, g, cg).sum((1, 3)) / count
    m1 = m1.repeat_interleave(cg, dim=-1)[:, None, :]
    m2 = m2.repeat_interleave(cg, dim=-1)[:, None, :]
    dx = rstd_c * (dxhat - m1 - xhat * m2)
    return dx.reshape(x.shape).to(x.dtype), dgamma, dbeta


def _check(x, gamma, beta, num_groups) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32) or not x.is_contiguous():
        raise ValueError(
            f"group_norm kernels take a contiguous bf16 or fp32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if not supported(x, num_groups):
        raise ValueError(
            f"group_norm kernels take what the gate supports: rank >= 3, C % groups == 0, "
            f"S >= 8 with a power-of-two divisor in [8, 512]; got {tuple(x.shape)}, "
            f"{num_groups} groups"
        )
    c = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"group_norm kernels need a contiguous ({c},) {name} on {x.device}")


def _block_c(c: int) -> int:
    """Channels a program: the largest power of two up to 128 that divides
    C, or C rounded up to a power of two (masked) when none of 16 and up do."""
    for block in (128, 64, 32, 16):
        if c % block == 0:
            return block
    return min(128, 1 << (c - 1).bit_length())


def stats_split(b: int, s: int, c: int) -> int:
    """Rows of one part of S in the statistics pass: a function of the
    shape alone, so that the partial sums, and their sum in split order,
    are the same on every run."""
    row_steps = -(-s // _STATS_ROWS)
    channel_blocks = -(-c // _block_c(c))
    parts = min(row_steps, max(1, -(-_STATS_PROGRAMS // (b * channel_blocks))))
    return -(-row_steps // parts) * _STATS_ROWS


def _forward(x, gamma, beta, num_groups, eps, act):
    if act not in _ACTS:
        raise ValueError(f"group_norm takes act None or 'silu', got {act!r}")
    if not x.is_cuda:
        return group_norm_reference(x, gamma, beta, num_groups, eps, act)
    _check(x, gamma, beta, num_groups)
    kernels = _build.triton_module("group_norm")
    b, s, c = _dims(x)
    block_c = _block_c(c)
    rows_per_part = stats_split(b, s, c)
    parts = -(-s // rows_per_part)
    partial = torch.empty((b, parts, 2, c), device=x.device, dtype=torch.float32)
    kernels.group_norm_stats_kernel[(parts, -(-c // block_c), b)](
        x, partial, s, c, rows_per_part,
        BLOCK_S=_STATS_ROWS, BLOCK_C=block_c, num_warps=4,
    )
    moments = partial.sum(1)  # (B, 2, C): the parts in order, no atomics
    mean_c, rstd_c = _group_moments(moments[:, 0], moments[:, 1], s, num_groups, eps)
    y = torch.empty_like(x)
    kernels.group_norm_apply_kernel[(-(-s // _NORM_ROWS), -(-c // block_c), b)](
        x, mean_c, rstd_c, gamma, beta, y, s, c,
        SILU=act == "silu", BLOCK_S=_NORM_ROWS, BLOCK_C=block_c, num_warps=4,
    )
    group_norm.launches += 1
    return y


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        ctx.save_for_backward(x, gamma, beta)
        ctx.config = (num_groups, eps, act)
        return _forward(x, gamma, beta, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_backward(x, gamma, beta, dy, *ctx.config)
        return dx, dgamma, dbeta, None, None, None


def group_norm(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    num_groups: int,
    eps: float,
    act: Optional[str] = None,
) -> torch.Tensor:
    """GroupNorm(+SiLU) of NHWC / NSC ``x`` with (C,) ``gamma``, ``beta``;
    returns x's dtype. Differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        return _GroupNorm.apply(x, gamma, beta, num_groups, eps, act)
    return _forward(x, gamma, beta, num_groups, eps, act)


group_norm.launches = 0
