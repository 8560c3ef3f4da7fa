"""The backward of the port's key-masked (B, H, S, D) flash attention, on
the CPU.

On CPU tensors the wrappers of the backward kernels return the plain
backward (``flash_attention_masked_backward_reference``'s arithmetic),
held here against ``jax.grad`` through the JAX package's Pallas kernels in
interpret mode (``flash_attention_tpu(..., interpret=True)``, with k and v
repeated over the query heads, as the JAX NextDiT does) and against torch
autograd through the plain forward. The kernels themselves are held
against the plain backward on the card by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.ops.pallas.flash_attention import flash_attention_tpu, flash_attention_with_lse

import vision_ft_tpu_torch.ops.flash_attention as flash_module
from vision_ft_tpu_torch.nn import remat_layer, set_remat_saves
from vision_ft_tpu_torch.ops.flash_attention import (
    flash_attention_masked,
    flash_attention_masked_backward,
    flash_attention_masked_backward_reference,
    flash_attention_masked_delta,
    flash_attention_masked_dkv,
    flash_attention_masked_dq,
    flash_attention_reference,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU: the Pallas interpret run sums over key and query blocks,
# the plain backward over whole rows, and the grouped heads' dk and dv sum
# up to 4 heads; gradients of O(1) inputs agree to fp32 rounding of a few
# hundred terms (the forward's 2e-5 of tests/test_torch_flash_masked.py)
GRAD_TOL = 5e-5

WRAPPERS = (flash_attention_masked, flash_attention_masked_dkv, flash_attention_masked_dq)


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
    elif kind == "empty_row":  # batch entry 1 keeps no key at all
        mask[1] = False
    return mask


def _jax_grads(q, k, v, mask, dout, causal, rep):
    def loss(q, k, v):
        out = flash_attention_tpu(
            q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
            mask=None if mask is None else jnp.asarray(mask), scale=q.shape[-1] ** -0.5,
            is_causal=causal, interpret=True,
        )
        return jnp.sum(out * jnp.asarray(dout))

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize(
    "b,h,hk,sq,sk,d,mask_kind,causal",
    [
        (2, 4, 4, 256, 256, 96, "hole", False),  # the Lumina2 head dim, a mask with a hole
        (1, 4, 4, 256, 256, 96, "ones", False),  # all-ones mask (the noise refiner)
        (1, 4, 4, 256, 256, 96, None, False),
        (1, 4, 2, 256, 256, 96, "hole", False),  # grouped-query heads: 2 kv heads of 4
        (1, 4, 1, 256, 256, 96, "hole", False),  # one kv head
        (1, 2, 2, 256, 256, 64, "hole", False),
        (1, 2, 1, 256, 256, 128, "hole", False),
        (1, 2, 2, 256, 256, 96, None, True),     # causal
        (1, 4, 2, 300, 300, 64, "hole", True),   # causal and masked, ragged
        (2, 4, 2, 260, 300, 96, "hole", False),  # ragged, sq != sk
        (2, 2, 1, 256, 256, 64, "empty_row", False),  # a batch entry with every key masked
    ],
)
def test_masked_plain_backward_matches_jax_kernel(b, h, hk, sq, sk, d, mask_kind, causal):
    """The plain backward (fed the plain forward's out and lse), the
    wrappers' autograd function on CPU tensors (which launches nothing) and,
    where no row is fully masked, torch autograd through the plain forward,
    against jax.grad of the interpreted Pallas kernels."""
    q, k, v = _rand(0, (b, h, sq, d)), _rand(1, (b, hk, sk, d)), _rand(2, (b, hk, sk, d))
    dout = _rand(3, (b, h, sq, d))
    mask = _mask(mask_kind, b, sk)
    want = _jax_grads(q, k, v, mask, dout, causal, h // hk)

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    tdout = torch.from_numpy(dout)
    with torch.no_grad():
        out, lse = flash_attention_reference(*leaves, tmask, None, causal, return_lse=True)
        plain = flash_attention_masked_backward_reference(*leaves, tmask, out, lse, tdout, None, causal)
    before = [w.launches for w in WRAPPERS]
    through_wrapper = torch.autograd.grad(
        (flash_attention_masked(*leaves, tmask, None, causal) * tdout).sum(), leaves
    )
    assert [w.launches for w in WRAPPERS] == before
    for name, got, wrapped, ref, x in zip(("dq", "dk", "dv"), plain, through_wrapper, want, (q, k, v)):
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
        torch.testing.assert_close(wrapped, got, rtol=0, atol=0, msg=name)
    if mask_kind != "empty_row":  # there the kernel's rule is not the formula's gradient
        through_plain_forward = torch.autograd.grad(
            (flash_attention_reference(*leaves, tmask, None, causal) * tdout).sum(), leaves
        )
        for name, got, auto in zip(("dq", "dk", "dv"), plain, through_plain_forward):
            np.testing.assert_allclose(got.numpy(), auto.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)


def test_fully_masked_row_spreads_its_gradient_over_every_key():
    """A row with every key masked has lse -1e30, so P = exp(-1e30 - lse) is
    1 on each key: dv of that batch entry is the column sum of dO, as the
    TPU kernel gives it."""
    b, h, s, d = 2, 2, 256, 64
    q, k, v, dout = _rand(4, (b, h, s, d)), _rand(5, (b, h, s, d)), _rand(6, (b, h, s, d)), _rand(7, (b, h, s, d))
    mask = _mask("empty_row", b, s)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    _, _, dv = torch.autograd.grad(
        (flash_attention_masked(*leaves, torch.from_numpy(mask)) * torch.from_numpy(dout)).sum(), leaves
    )
    want = np.broadcast_to(dout[1].sum(axis=1, keepdims=True), dout[1].shape)
    np.testing.assert_allclose(dv[1].numpy(), want, atol=GRAD_TOL * s, rtol=GRAD_TOL)


@pytest.mark.parametrize("sq,sk,d", [(256, 256, 96), (200, 300, 64)])
def test_lse_cotangent_matches_jax(sq, sk, d):
    """A loss that reads the returned lse too: its gradient shifts delta by
    dlse, as ``flash_attention_with_lse``'s custom VJP does."""
    q, k, v = _rand(8, (1, 2, sq, d)), _rand(9, (1, 2, sk, d)), _rand(10, (1, 2, sk, d))
    dout, dlse = _rand(11, (1, 2, sq, d)), _rand(12, (1, 2, sq))

    def jax_loss(q, k, v):
        out, lse = flash_attention_with_lse(q, k, v, interpret=True)
        return jnp.sum(out * jnp.asarray(dout)) + jnp.sum(lse * jnp.asarray(dlse))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention_masked(*leaves, return_lse=True)
    loss = (out * torch.from_numpy(dout)).sum() + (lse * torch.from_numpy(dlse)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, ref in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name)
    # the same through the backward's own argument
    with torch.no_grad():
        direct = flash_attention_masked_backward(
            *leaves, None, out, lse, torch.from_numpy(dout), dlse=torch.from_numpy(dlse)
        )
    for g, dg in zip(got, direct):
        torch.testing.assert_close(g, dg, rtol=0, atol=0)


def test_delta_and_the_two_wrappers_split_the_backward():
    b, h, hk, s, d = 1, 4, 2, 256, 96
    q, k, v, dout = (torch.from_numpy(_rand(13 + i, (b, n, s, d))) for i, n in enumerate((h, hk, hk, h)))
    mask = torch.from_numpy(_mask("hole", b, s))
    out, lse = flash_attention_reference(q, k, v, mask, return_lse=True)
    delta = flash_attention_masked_delta(out, dout)
    assert delta.shape == (b, h, s) and delta.dtype == torch.float32 and delta.is_contiguous()
    torch.testing.assert_close(delta, (out * dout).sum(-1), rtol=1e-6, atol=1e-6)
    dk, dv = flash_attention_masked_dkv(q, k, v, mask, dout, lse, delta)
    dq = flash_attention_masked_dq(q, k, v, mask, dout, lse, delta)
    want = flash_attention_masked_backward(q, k, v, mask, out, lse, dout)
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["kernel", "none"])
def test_autograd_function_inside_a_remat_layer(monkeypatch, mode):
    """Checkpointed, the attention gives the same gradients bit for bit; in
    the "kernel" mode the recomputation takes the recorded (out, lse) and
    does not run the forward again, in "none" it does."""
    b, h, hk, s, d = 2, 4, 2, 256, 64
    arrays = [_rand(20, (b, s, h * d)), _rand(21, (h * d, h * d)), _rand(22, (h * d, 2 * hk * d))]
    mask = torch.from_numpy(_mask("hole", b, s))
    calls = []
    forward = flash_module._masked_forward

    def counted(*args, **kwargs):
        calls.append(1)
        return forward(*args, **kwargs)

    monkeypatch.setattr(flash_module, "_masked_forward", counted)

    def region(x, wq, wkv):
        # two attentions, as a group of two blocks: q from x, k and v from one projection
        for _ in range(2):
            q = (x @ wq * 0.05).reshape(b, s, h, d).transpose(1, 2)
            kv = (x @ wkv * 0.05).reshape(b, s, 2 * hk, d).transpose(1, 2)
            out = flash_attention_masked(q, kv[:, :hk], kv[:, hk:], mask)
            x = x + out.transpose(1, 2).reshape(b, s, h * d)
        return x

    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    want = torch.autograd.grad(region(*leaves).square().sum(), leaves)
    calls.clear()
    set_remat_saves(mode)
    try:
        got = torch.autograd.grad(remat_layer(region)(*leaves).square().sum(), leaves)
    finally:
        set_remat_saves("activations")
    assert len(calls) == (2 if mode == "kernel" else 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
