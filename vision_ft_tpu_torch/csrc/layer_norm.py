"""Fused LayerNorm forward, Triton, for Hopper.

Replaces ``vision_ft_tpu/ops/pallas/layer_norm.py`` ``_ln_kernel`` /
``_ln_kernel_nobeta`` (called through ``_layer_norm_fwd_2d``).

What bounds it on an H100: nothing but device memory. A row of C bf16
values is read once and written once, with a few flops per element, far
below the card's ~295 flop/byte balance point; the SDXL UNet's 210
norms per forward at 1024 px move about 2.5 GB per CFG step. So the
design is one pass: one program owns one row, loads it once into
registers (C <= 8192, padded to a power of two and masked), takes
mean and variance in fp32 from those registers, and writes the
normalized, affine row once. No shared-memory staging, no second read.

Loaded by ``ops/_build.py`` from this file, never imported with the
package: it imports ``triton`` at the top.
"""

import triton
import triton.language as tl


@triton.jit
def layer_norm_fwd_kernel(
    x_ptr, w_ptr, b_ptr, y_ptr,
    stride_x, stride_y, C, eps,
    HAS_BIAS: tl.constexpr,
    BLOCK_C: tl.constexpr,
):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_C)
    mask = cols < C
    x = tl.load(x_ptr + row * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=0) / C
    centered = tl.where(mask, x - mean, 0.0)
    var = tl.sum(centered * centered, axis=0) / C
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = centered * rstd * w
    if HAS_BIAS:
        y += tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    tl.store(y_ptr + row * stride_y + cols, y.to(y_ptr.dtype.element_ty), mask=mask)
