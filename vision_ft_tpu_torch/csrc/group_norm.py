"""Fused GroupNorm (+ optional SiLU) forward, Triton, for Hopper (kernel J).

Replaces ``vision_ft_tpu/ops/pallas/group_norm.py`` ``_stats_kernel`` and
``_norm_kernel`` (called by ``_gn_fwd_impl``, entry ``group_norm_tpu``).

What bounds it on an H100: device memory. x (B, S, C) is read twice (once
for the statistics, once to normalize) and y written once, with a few
flops an element, far below the card's ~295 flop/byte balance point. So
the design streams: 2-D tiles of rows x channels, channels contiguous,
fp32 inside, the affine and the SiLU fused into the normalize pass.

- ``group_norm_stats_kernel``: the TPU kernel carries per-channel sums in
  one output block across its sequential spatial grid axis. The H100's
  blocks run in parallel and in no order, so S is cut into parts whose
  size depends on the shape alone (``ops/group_norm.py`` ``stats_split``):
  a program sums its part's rows into (BLOCK_S, BLOCK_C) fp32
  accumulators, folds them to per-channel sums and sums of squares, and
  writes them as partials (B, parts, 2, C). The wrapper sums the parts in
  order; no atomics, so reruns are bit-identical. One program per
  channel block would leave an H100 nearly idle at the VAE's (1, 1024^2,
  128): 4 programs on 132 SMs.
- The group combine of the per-channel moments happens outside, on (B, C)
  tensors, as the JAX package does it in XLA.
- ``group_norm_apply_kernel``: one (BLOCK_S, BLOCK_C) tile a program,
  ``(x - mean) * rstd * gamma + beta``, SiLU, cast to x's dtype.

Loaded by ``ops/_build.py`` from this file, never imported with the
package: it imports ``triton`` at the top.
"""

import triton
import triton.language as tl


@triton.jit
def group_norm_stats_kernel(
    x_ptr, part_ptr, S, C, rows_per_part,
    BLOCK_S: tl.constexpr,
    BLOCK_C: tl.constexpr,
):
    part = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2).to(tl.int64)
    parts = tl.num_programs(0)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    row0 = part * rows_per_part
    row_end = tl.minimum(row0 + rows_per_part, S)
    base = x_ptr + b * S * C
    acc = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
    acc_sq = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
    for r in range(row0, row_end, BLOCK_S):
        rows = r + tl.arange(0, BLOCK_S)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        offsets = rows.to(tl.int64)[:, None] * C + cols[None, :]
        x = tl.load(base + offsets, mask=mask, other=0.0).to(tl.float32)
        acc += x
        acc_sq += x * x
    out = part_ptr + (b * parts + part) * 2 * C
    tl.store(out + cols, tl.sum(acc, axis=0), mask=cmask)
    tl.store(out + C + cols, tl.sum(acc_sq, axis=0), mask=cmask)


@triton.jit
def group_norm_apply_kernel(
    x_ptr, mean_ptr, rstd_ptr, gamma_ptr, beta_ptr, y_ptr, S, C,
    SILU: tl.constexpr,
    BLOCK_S: tl.constexpr,
    BLOCK_C: tl.constexpr,
):
    sb = tl.program_id(0)
    cb = tl.program_id(1)
    b = tl.program_id(2).to(tl.int64)
    rows = sb * BLOCK_S + tl.arange(0, BLOCK_S)
    cols = cb * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < C
    mask = (rows < S)[:, None] & cmask[None, :]
    offsets = b * S * C + rows.to(tl.int64)[:, None] * C + cols[None, :]
    x = tl.load(x_ptr + offsets, mask=mask, other=0.0).to(tl.float32)
    mean = tl.load(mean_ptr + b * C + cols, mask=cmask, other=0.0)
    rstd = tl.load(rstd_ptr + b * C + cols, mask=cmask, other=0.0)
    gamma = tl.load(gamma_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    beta = tl.load(beta_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    out = (x - mean[None, :]) * rstd[None, :]
    out = out * gamma[None, :] + beta[None, :]
    if SILU:
        out = out * tl.sigmoid(out)
    tl.store(y_ptr + offsets, out.to(y_ptr.dtype.element_ty), mask=mask)
