"""The key-masked (B, H, S, D) flash attention of the port, on the CPU.

On a CPU tensor the wrapper returns its plain PyTorch version, held here
against the JAX package's Pallas kernel run in interpret mode
(``flash_attention_tpu(..., interpret=True)``, as tests/ops/
test_flash_attention.py runs it) and against ``_xla_attention``; the
routing (``ops.flash_attention.flash_attention`` and ``ops.attention.
scaled_dot_product_attention``) against the JAX package's on the CPU. The
kernel itself is held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.ops.attention import _xla_attention
from vision_ft_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from vision_ft_tpu.ops.flash_attention import _as_key_mask as jax_as_key_mask
from vision_ft_tpu.ops.pallas.flash_attention import flash_attention_tpu, flash_attention_with_lse

from vision_ft_tpu_torch.ops import flash_attention as flash_module
from vision_ft_tpu_torch.ops.attention import plain_attention, scaled_dot_product_attention
from vision_ft_tpu_torch.ops.flash_attention import (
    MASKED_HEAD_DIMS,
    _as_key_mask,
    _check_masked,
    flash_attention,
    flash_attention_masked,
    flash_attention_reference,
    supports,
    supports_backward,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 attention on the CPU: the Pallas interpret run takes an online
# softmax over key blocks, the plain version one softmax over all keys; the
# two agree to fp32 rounding of O(1) outputs (the JAX package's own
# kernel-vs-XLA tolerance, tests/ops/test_flash_attention.py)
ATTN_TOL = 2e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(kind, b, sk):
    """hole: the Lumina2 joint mask, [caption, right padded | image]."""
    if kind is None:
        return None
    mask = np.ones((b, sk), bool)
    if kind == "hole":
        for i in range(b):
            mask[i, 5 + 9 * i: sk // 3] = False
    return mask


@pytest.mark.parametrize(
    "b,h,sq,sk,d,mask_kind,causal",
    [
        (2, 2, 256, 256, 96, "hole", False),   # the Lumina2 head dim, a mask with a hole
        (1, 2, 256, 256, 96, "ones", False),   # all-ones mask (the noise refiner)
        (1, 2, 256, 256, 96, None, False),
        (1, 2, 256, 256, 64, "hole", False),
        (1, 1, 256, 256, 128, "hole", False),
        (2, 2, 300, 300, 96, "hole", False),   # ragged lengths
        (1, 2, 260, 390, 64, "hole", False),   # ragged, sq != sk
        (1, 2, 256, 256, 96, None, True),      # causal
        (1, 2, 300, 300, 64, "hole", True),    # causal and masked, ragged
    ],
)
def test_masked_plain_matches_jax_kernel(b, h, sq, sk, d, mask_kind, causal):
    q, k, v = _rand(0, (b, h, sq, d)), _rand(1, (b, h, sk, d)), _rand(2, (b, h, sk, d))
    mask = _mask(mask_kind, b, sk)
    scale = d**-0.5
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask, scale=scale,
        is_causal=causal, interpret=True,
    ))
    xla = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jmask[:, None, None, :], scale, causal,
    ))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    plain, lse = flash_attention_reference(tq, tk, tv, tmask, scale, causal, return_lse=True)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(plain.numpy(), xla, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = flash_attention_masked.launches
    got = flash_attention_masked(tq, tk, tv, tmask, scale, causal)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert flash_attention_masked.launches == before


@pytest.mark.parametrize("sq,sk,d", [(256, 256, 96), (300, 390, 64)])
def test_masked_plain_lse_matches_jax_kernel(sq, sk, d):
    q, k, v = _rand(3, (1, 2, sq, d)), _rand(4, (1, 2, sk, d)), _rand(5, (1, 2, sk, d))
    want_out, want_lse = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True
    )
    out, lse = flash_attention_masked(*(torch.from_numpy(x) for x in (q, k, v)), return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATTN_TOL, rtol=ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATTN_TOL, rtol=ATTN_TOL)


def test_fully_masked_row_follows_the_kernel_not_the_plain_formula():
    """A batch entry with every key masked: the JAX kernel (a finite -1e30)
    gives the mean of v, and so does the port's plain version of the
    kernel, with an lse of about -1e30; ``_xla_attention`` and the port's
    ``plain_attention`` give 0."""
    b, h, s, d = 2, 2, 256, 64
    q, k, v = _rand(6, (b, h, s, d)), _rand(7, (b, h, s, d)), _rand(8, (b, h, s, d))
    mask = np.ones((b, s), bool)
    mask[1] = False
    want = np.asarray(flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask), interpret=True
    ))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got, lse = flash_attention_masked(tq, tk, tv, torch.from_numpy(mask), return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)
    mean_v = np.broadcast_to(v[1].mean(axis=1, keepdims=True), v[1].shape)
    np.testing.assert_allclose(got[1].numpy(), mean_v, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert (lse[1] < -0.99e30).all() and torch.isfinite(lse).all()
    xla = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)[:, None, None, :],
        d**-0.5, False,
    ))
    plain = plain_attention(tq, tk, tv, torch.from_numpy(mask)[:, None, None, :], d**-0.5, False)
    assert not xla[1].any() and not plain[1].any()
    np.testing.assert_allclose(plain.numpy(), xla, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("kv_heads", [1, 2, 4])
def test_grouped_query_heads_match_repeated_heads(kv_heads):
    """k and v with fewer heads than q: query head h reads kv head
    h // repeats, as ``jnp.repeat`` along the head axis lays them out."""
    b, h, s, d = 1, 4, 256, 96
    q, k, v = _rand(9, (b, h, s, d)), _rand(10, (b, kv_heads, s, d)), _rand(11, (b, kv_heads, s, d))
    mask = _mask("hole", b, s)
    rep = h // kv_heads
    want = np.asarray(flash_attention_tpu(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1), jnp.repeat(jnp.asarray(v), rep, axis=1),
        mask=jnp.asarray(mask), interpret=True,
    ))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention_masked(tq, tk, tv, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)
    routed = scaled_dot_product_attention(
        tq, tk, tv, mask=torch.from_numpy(mask)[:, None, None, :], backend="flash"
    )
    np.testing.assert_allclose(routed.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize(
    "mask_kind,causal,backend",
    [
        (None, False, "flash"),
        ("key2d", False, "flash"),
        ("key4d", False, "flash"),
        ("key4d", True, "flash"),
        ("full_bool", False, "flash"),
        ("additive", False, "flash_attention_2"),
        ("key4d", False, "xla"),
        (None, True, "sdpa"),
    ],
)
def test_routing_matches_jax_on_the_cpu(mask_kind, causal, backend):
    """``scaled_dot_product_attention`` and ``flash_attention`` of the port
    against the JAX package's dispatch for every kind of mask."""
    b, h, sq, sk, d = 2, 2, 260, 260, 64
    q, k, v = _rand(12, (b, h, sq, d)), _rand(13, (b, h, sk, d)), _rand(14, (b, h, sk, d))
    rng = np.random.default_rng(15)
    key = _mask("hole", b, sk)
    mask = {
        None: None, "key2d": key, "key4d": key[:, None, None, :],
        "full_bool": rng.random((b, 1, sq, sk)) > 0.3,
        "additive": rng.standard_normal((b, h, sq, sk)).astype(np.float32),
    }[mask_kind]
    if mask_kind == "key2d":  # (B, Sk) is a key mask for the flash entry only
        want = np.asarray(flash_attention_tpu(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
            is_causal=causal, interpret=True,
        ))
        got = flash_attention_masked(*(torch.from_numpy(x) for x in (q, k, v)),
                                     torch.from_numpy(mask), None, causal)
    else:
        want = np.asarray(jax_sdpa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if mask is None else jnp.asarray(mask), backend=backend, is_causal=causal,
        ))
        tmask = None if mask is None else torch.from_numpy(mask)
        got = scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), mask=tmask, backend=backend,
            is_causal=causal,
        )
        if backend != "xla" and backend != "sdpa":
            direct = flash_attention(
                *(torch.from_numpy(x) for x in (q, k, v)), mask=tmask, is_causal=causal
            )
            torch.testing.assert_close(direct, got, rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=ATTN_TOL)


def test_unknown_backend_raises():
    q = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError):
        scaled_dot_product_attention(q, q, q, backend="flash3")


@pytest.mark.parametrize(
    "shape,dtype,taken",
    [
        ((2, 300), bool, True),
        ((300,), bool, True),
        ((2, 1, 1, 300), bool, True),
        ((1, 1, 1, 300), bool, True),
        ((2, 1, 7, 300), bool, False),
        ((2, 4, 1, 300), bool, False),
        ((2, 300), np.float32, False),
    ],
)
def test_as_key_mask_matches_jax(shape, dtype, taken):
    mask = (np.random.default_rng(16).random(shape) > 0.4).astype(dtype)
    want = jax_as_key_mask(jnp.asarray(mask), 2, 300)
    got = _as_key_mask(torch.from_numpy(mask), 2, 300)
    assert (got is not None) == (want is not None) == taken
    if taken:
        assert got.shape == (2, 300) and got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _as_key_mask(None, 2, 300) is None


def test_head_dims_per_kernel():
    for d in (32, 48, 64, 96, 128, 256):
        q = torch.zeros(1, 1, 256, d, dtype=torch.bfloat16)
        # a CPU tensor is refused either way: for its head dim first, else for where it lies
        with pytest.raises(ValueError, match="bf16 on" if d in MASKED_HEAD_DIMS else "head dims"):
            _check_masked(q, q, q, None)
    assert [d for d in (32, 48, 64, 96, 128, 256) if supports(4, d)] == [64, 128, 256]
    assert [d for d in (32, 48, 64, 96, 128, 256) if supports_backward(4, d)] == [64, 128, 256]
    assert flash_module.BSHD_FWD_HEAD_DIMS == (64, 128, 256)
    assert flash_module.BSHD_BWD_HEAD_DIMS == (64, 128, 256) and MASKED_HEAD_DIMS == (64, 96, 128)


@pytest.mark.parametrize(
    "case",
    ["head_dim", "kv_heads", "kv_shape", "mask_shape", "mask_dtype", "rank", "cpu_tensor"],
)
def test_masked_kernel_rejects_what_it_cannot_take(case):
    q = torch.zeros(2, 4, 256, 96, dtype=torch.bfloat16)
    k = v = torch.zeros(2, 2, 256, 96, dtype=torch.bfloat16)
    mask = torch.ones(2, 256, dtype=torch.bool)
    if case == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif case == "kv_heads":
        k = v = torch.zeros(2, 3, 256, 96, dtype=torch.bfloat16)
    elif case == "kv_shape":
        v = v[:, :, :-1]
    elif case == "mask_shape":
        mask = mask[:, :-1]
    elif case == "mask_dtype":
        mask = mask.float()
    elif case == "rank":
        q = q[0]
    # "cpu_tensor": everything else is right, but the kernel takes CUDA tensors only
    with pytest.raises(ValueError):
        _check_masked(q, k, v, mask)


def test_causal_needs_equal_lengths():
    q, k = torch.zeros(1, 1, 256, 64), torch.zeros(1, 1, 300, 64)
    with pytest.raises(ValueError):
        flash_attention_masked(q, k, k, is_causal=True)
