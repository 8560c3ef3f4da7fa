"""The port's two kernel modules: BSHD flash attention and fused LayerNorm.

On the CPU the wrappers return their plain PyTorch versions, which are
held here against the JAX package: the BSHD plain version against the
Pallas kernel run in interpret mode (as tests/ops/test_flash_attention.py
runs it), the LayerNorm plain version against vision_ft_tpu.nn.LayerNorm,
whose CPU formula is the kernel's formula.

The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.ops.attention import attention_heads_packed as jax_attention_heads_packed
from vision_ft_tpu.ops.pallas.flash_attention import flash_attention_bshd as jax_flash_bshd

from vision_ft_tpu_torch.ops.attention import attention_heads_packed
from vision_ft_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_reference,
)
from vision_ft_tpu_torch.ops.layer_norm import layer_norm, layer_norm_reference

# fp32 attention on the CPU: the Pallas interpret run takes an online
# softmax over 128-key blocks, the plain version one softmax over all
# keys; the two agree to fp32 rounding of O(1) outputs (the JAX package's
# own kernel-vs-XLA tolerance, tests/ops/test_flash_attention.py)
ATTN_TOL = 2e-5
FP32_TOL = 1e-5


def _rand(seed, shape, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (1, 256, 256, 2, 64),   # aligned, SDXL head dim
        (2, 300, 300, 4, 64),   # ragged self-attention lengths
        (1, 260, 390, 2, 64),   # ragged, sq != sk
        (1, 256, 256, 2, 128),  # the kernel's other head dim
    ],
)
def test_bshd_plain_matches_jax_kernel(b, sq, sk, h, d):
    q, k, v = _rand(0, (b, sq, h * d)), _rand(1, (b, sk, h * d)), _rand(2, (b, sk, h * d))
    scale = d**-0.5
    want = np.asarray(
        jax_flash_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, scale=scale,
                       interpret=True)
    )
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    plain = flash_attention_bshd_reference(tq, tk, tv, h, scale)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = flash_attention_bshd.launches
    torch.testing.assert_close(flash_attention_bshd(tq, tk, tv, h, scale), plain, rtol=0, atol=0)
    assert flash_attention_bshd.launches == before


@pytest.mark.parametrize(
    "sq,sk,backend",
    [(256, 256, "flash"), (300, 77, "flash"), (256, 256, "xla")],
)
def test_attention_heads_packed_matches_jax(sq, sk, backend):
    h, d = 4, 64
    q, k, v = _rand(3, (2, sq, h * d)), _rand(4, (2, sk, h * d)), _rand(5, (2, sk, h * d))
    want = np.asarray(
        jax_attention_heads_packed(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, backend=backend
        )
    )
    got = attention_heads_packed(
        *(torch.from_numpy(x) for x in (q, k, v)), h, backend=backend
    )
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("rows,c,bias", [(64, 640, True), (154, 768, True), (9, 1280, False)])
def test_layer_norm_plain_matches_jax(rows, c, bias):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((rows, c)) * 2 + 0.3).astype(np.float32)
    params = {"weight": rng.normal(1, 0.2, (c,)).astype(np.float32)}
    if bias:
        params["bias"] = rng.normal(0, 0.2, (c,)).astype(np.float32)
    want = np.asarray(
        jnn.LayerNorm(c, bias=bias)({k: jnp.asarray(p) for k, p in params.items()}, jnp.asarray(x))
    )
    weight = torch.from_numpy(params["weight"])
    beta = torch.from_numpy(params["bias"]) if bias else None
    plain = layer_norm_reference(torch.from_numpy(x), weight, beta, 1e-5)
    np.testing.assert_allclose(plain.numpy(), want, atol=FP32_TOL, rtol=FP32_TOL)
    before = layer_norm.launches
    torch.testing.assert_close(layer_norm(torch.from_numpy(x), weight, beta), plain, rtol=0, atol=0)
    assert layer_norm.launches == before
