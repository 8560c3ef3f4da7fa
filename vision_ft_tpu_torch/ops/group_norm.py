"""Fused GroupNorm (+ optional SiLU): wrapper, gate, plain version and backward.

Counterpart of ``vision_ft_tpu/ops/pallas/group_norm.py::group_norm_tpu``,
its custom VJP and its gate ``supported``. As there, the op is available
and no model path calls it: ``nn.core.GroupNorm`` keeps its own formula.
The forward is one launch of the CUDA C++ kernel ``csrc/group_norm.cu``
(statistics, the group combine and the normalize pass in one cooperative
grid, built for ``sm_90a`` by ``ops/_build.py`` and bound with
``ctypes``); the backward is, as in the JAX package, a plain formula
outside any kernel.

- :func:`group_norm_reference` is the plain PyTorch version, the JAX
  ``_gn_fwd_impl`` formula: fp32 per-channel sums and sums of squares over
  the spatial rows, the group mean and ``var = E[x^2] - mean^2`` from
  them, ``rsqrt(var + eps)``, the affine, the optional SiLU, cast to x's
  dtype.
- :func:`group_norm_backward` is the JAX ``_gn_bwd`` formula: fp32, the
  statistics recomputed from x, dgamma and dbeta in their own dtypes.
- :func:`supported` is the JAX gate, kept as a copy (pure shape logic).
- :func:`gn_plan` is the kernel's launch plan, a pure function of the
  shape and the SM count.
- :func:`group_norm` is the wrapper. For a CPU tensor its forward is the
  plain version. For a CUDA tensor it launches the kernel or raises
  ``ValueError`` (a dtype other than bf16 / fp32 for x, gamma or beta, a
  non-contiguous or unaligned x, a shape the gate rejects, an unknown
  ``act``) or ``RuntimeError`` (a launch the card refuses); it counts its
  launches in ``group_norm.launches``. When gradients are wanted it goes
  through a ``torch.autograd.Function`` that keeps (x, gamma, beta) and
  whose backward is :func:`group_norm_backward`.

Layout: x is (B, ..., C), seen as (B, S, C) with S the product of the
middle axes; gamma and beta are (C,).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from . import _build

_ACTS = (None, "silu")
_THREADS = 512  # kernel J's block
_SMEM = 232448  # dynamic shared memory a block may use on an H100


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


class GnPlan(NamedTuple):
    blocks: int      # blocks of the cooperative grid, one an SM at most
    parts: int       # parts of S a batch entry is cut into: B * parts work items
    rows: int        # rows of a part (the last part may be shorter)
    chunk_rows: int  # rows of one bulk copy into shared memory


_STAGES = 4           # the kernel's ring of chunks, a barrier each
_CHUNK_BYTES = 32768  # about the bytes of one chunk


def _vec_bytes(c: int, itemsize: int) -> int:
    """Bytes of one access: 16, or 8, 4, 2 where a row of C is not a
    multiple of 16 bytes."""
    row = c * itemsize
    return next(n for n in (16, 8, 4, 2) if row % n == 0)


def _fixed_smem(c: int, groups: int, itemsize: int) -> int:
    """Shared memory of a block besides the rows: the per-lane, per-channel
    table of sums, the group statistics and the barriers (the layout of
    ``csrc/group_norm.cu``)."""
    vecs = c // (_vec_bytes(c, itemsize) // itemsize)
    lanes = 1 if vecs >= _THREADS else _THREADS // vecs
    return -(-lanes * c * 8 // 16) * 16 + (groups + groups % 2) * 8 + _STAGES * 8


def _chunk_rows(c: int, itemsize: int) -> int:
    step = 16 // math.gcd(16, c * itemsize)  # rows whose bytes are a multiple of 16
    return max(step, _CHUNK_BYTES // (c * itemsize) // step * step)


def gn_plan(b: int, s: int, c: int, groups: int, itemsize: int, sms: int) -> GnPlan:
    """Kernel J's launch plan: one block an SM, each batch entry cut into
    parts of whole steps of rows (the fewest rows whose bytes are a multiple
    of 16, so every part and chunk starts 16-byte aligned) so that the B *
    parts items fill the SMs once; items past the grid run in rounds (only
    where B > sms, and then a batch entry is one item). Each pass streams
    chunks of about 32 KB through a ring of 4. A function of the shape and
    the card alone, so the partial sums, and their sum in part order, are
    the same on every run."""
    step = 16 // math.gcd(16, c * itemsize)
    steps = -(-s // step)
    parts = max(1, min(sms // b, steps))
    rows = -(-steps // parts) * step
    parts = -(-s // rows)
    return GnPlan(min(b * parts, sms), parts, rows, _chunk_rows(c, itemsize))


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
    if x.data_ptr() % 16:
        raise ValueError("group_norm kernels need x 16-byte aligned")
    c, itemsize = x.shape[-1], x.element_size()
    ring = _STAGES * _chunk_rows(c, itemsize) * c * itemsize
    if c // (_vec_bytes(c, itemsize) // itemsize) > 2 * _THREADS or (
            _fixed_smem(c, num_groups, itemsize) + ring > _SMEM):
        raise ValueError(f"group_norm kernels take rows of at most {2 * _THREADS} vectors whose "
                         f"sums and ring of chunks fit shared memory: C = {c} is too wide")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (c,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"group_norm kernels need a contiguous ({c},) {name} on {x.device}")
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"group_norm kernels take a bf16 or fp32 {name}, got {t.dtype}")


@functools.cache
def _kernel():
    fn = _build.cuda_library("group_norm").group_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, gamma, beta, num_groups, eps, act, plan: GnPlan):
    """y of kernel J under ``plan``: one ``torch.empty`` for y, one for the
    fp32 partials (B, groups, parts, 2), one launch."""
    b, s, c = _dims(x)
    y = torch.empty_like(x)
    partial = torch.empty((b, num_groups, plan.parts, 2), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(), partial.data_ptr(),
            b, s, c, num_groups, x.element_size(),
            int(gamma.dtype == torch.bfloat16), int(beta.dtype == torch.bfloat16),
            plan.blocks, plan.parts, plan.rows, plan.chunk_rows, int(act == "silu"),
            float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"group_norm launch failed: CUDA error {err}")
    group_norm.launches += 1
    return y


def _forward(x, gamma, beta, num_groups, eps, act):
    if act not in _ACTS:
        raise ValueError(f"group_norm takes act None or 'silu', got {act!r}")
    if not x.is_cuda:
        return group_norm_reference(x, gamma, beta, num_groups, eps, act)
    _check(x, gamma, beta, num_groups)
    b, s, c = _dims(x)
    plan = gn_plan(b, s, c, num_groups, x.element_size(), _build.sm_count(x.device))
    return _launch(x, gamma, beta, num_groups, eps, act, plan)


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
