"""The port's fused GroupNorm(+SiLU) (``ops/group_norm.py``) against the JAX
package's ``group_norm_tpu``, whose Pallas kernels run in interpret mode
on the CPU by themselves, and its custom VJP. On the CPU the port's
wrapper takes its plain version; kernel J itself is held against that in
``tests/test_torch_cuda_kernels.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.ops.pallas.group_norm import group_norm_tpu
from vision_ft_tpu.ops.pallas.group_norm import supported as jax_supported

from vision_ft_tpu_torch.ops.group_norm import (
    group_norm,
    group_norm_backward,
    gn_plan,
    group_norm_reference,
    supported,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU: the JAX test's own limits (forward 1e-5, gradients
# 1e-4); both sides sum the same fp32 values in other orders.
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16 in and out, fp32 inside on both sides: the two outputs differ only
# where fp32 sums in other orders fall on either side of a bf16 rounding
# boundary, by one bf16 ulp (2**-7 of the value) at most
BF16_RTOL = 2.0**-7

SHAPES = [((2, 8, 8, 320), 32), ((2, 64, 128), 32)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.1 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, gamma, beta


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_forward_matches_jax_kernel(shape, groups, act):
    x, gamma, beta = _inputs(shape)
    want = group_norm_tpu(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), groups, 1e-5, act)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                     groups, 1e-5, act)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gradients_match_jax_vjp(shape, groups, act):
    """dx, dgamma and dbeta of sum(sin(gn(x))) through the port's
    autograd.Function against jax.grad through the custom VJP."""
    x, gamma, beta = _inputs(shape, seed=1)

    def loss(x_, g_, b_):
        return jnp.sum(jnp.sin(group_norm_tpu(x_, g_, b_, groups, 1e-5, act)))

    want = jax.grad(loss, (0, 1, 2))(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, gamma, beta)]
    torch.sin(group_norm(*leaves, groups, 1e-5, act)).sum().backward()
    for name, leaf, w in zip(("dx", "dgamma", "dbeta"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("act", [None, "silu"])
def test_bf16_matches_jax_kernel(act):
    x, gamma, beta = _inputs((2, 8, 8, 320), seed=2)
    xb = torch.from_numpy(x).bfloat16()
    want = group_norm_tpu(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(gamma),
                          jnp.asarray(beta), 32, 1e-5, act)
    got = group_norm(xb, torch.from_numpy(gamma), torch.from_numpy(beta), 32, 1e-5, act)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-6, rtol=BF16_RTOL)


def test_backward_keeps_the_affine_dtypes():
    x, gamma, beta = _inputs((2, 4, 4, 64), seed=3)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    dx, dgamma, dbeta = group_norm_backward(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(gamma).double(),
        torch.from_numpy(beta), torch.from_numpy(dy), 8, 1e-6, "silu")
    assert (dx.dtype, dgamma.dtype, dbeta.dtype) == (torch.bfloat16, torch.float64, torch.float32)


class _Shape:
    """What the JAX gate reads of an array: ndim, shape and size."""

    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)
        self.size = int(np.prod(shape))


GATE_SHAPES = [
    ((2, 320), 32),  # rank 2
    ((2, 4, 330), 32),  # channels not divisible into groups
    ((2, 2, 2, 64), 32),  # S = 4 < 8
    ((2, 3, 5, 64), 32),  # S = 15: no power-of-two divisor from 8
    ((2, 12, 64), 32),  # S = 12: divisible by 4 only
    ((2, 24, 64), 32),  # S = 24: block 8
    ((2, 8, 8, 320), 32),
    ((2, 64, 128), 32),
    ((1, 1, 1, 8, 64), 32),  # rank 5
    ((2, 128, 128, 320), 32),  # SDXL's UNet at 1024 px, batch 2
    ((2, 32, 32, 2560), 32),  # its up-block concat
    ((2, 4096, 640), 32),
    ((1, 1024, 1024, 128), 32),  # the VAE decoder's last stage
    ((1, 7, 9, 96), 32),  # S = 63
    ((3, 40, 40, 96), 24),  # S = 1600: block 64
    ((2, 8, 8, 320), 7),
]


@pytest.mark.parametrize("shape,groups", GATE_SHAPES)
def test_supported_is_the_jax_gate(shape, groups):
    assert supported(_Shape(shape), groups) == jax_supported(_Shape(shape), groups)
    assert supported(torch.empty(shape, device="meta"), groups) == jax_supported(
        _Shape(shape), groups)


def test_plain_version_is_the_wrapper_on_the_cpu():
    x, gamma, beta = (torch.from_numpy(a) for a in _inputs((2, 4, 4, 64), seed=5))
    before = group_norm.launches
    assert torch.equal(group_norm(x, gamma, beta, 8, 1e-5, "silu"),
                       group_norm_reference(x, gamma, beta, 8, 1e-5, "silu"))
    assert group_norm.launches == before
    with pytest.raises(ValueError, match="act"):
        group_norm(x, gamma, beta, 8, 1e-5, "gelu")


GN_PLAN_SMS = 132  # an H100's streaming multiprocessors


@pytest.mark.parametrize("b,s,c,itemsize,rounds", [
    (2, 16384, 320, 2, 1),        # the UNet at 1024 px, batch 2: 21 MB
    (1, 1024 * 1024, 128, 2, 1),  # the VAE decoder's last stage: 268 MB
    (2, 4096, 640, 2, 1),
    (4, 16384, 320, 2, 1),        # batch 4: 42 MB
    (2, 1024, 2560, 2, 1),        # the up-block concat
    (2, 24, 96, 2, 1),            # fewer rows than a part of every SM
    (1, 16384, 512, 2, 1),        # the VAE's 128 x 128 stage
    (1, 65536, 512, 2, 1),        # its 256 x 256 stage
    (2, 256, 64, 4, 1),           # fp32
    (2, 16384, 320, 4, 1),        # fp32 at the UNet's width: 42 MB
    (200, 64, 64, 2, 2),          # more batch entries than SMs: two rounds
    (1, 8, 24, 2, 1),             # one part of one 8-row step
])
def test_gn_plan_covers_s_and_fills_the_card(b, s, c, itemsize, rounds):
    """Kernel J's plan cuts each batch entry into parts of whole steps of
    rows (each part starts 16-byte aligned) that cover S exactly, one block
    an SM; items run in rounds only where a batch entry is one item, so a
    block combines no partial of a later round. A function of the shape and
    the SM count alone."""
    plan = gn_plan(b, s, c, 32 if c % 32 == 0 else 8, itemsize, GN_PLAN_SMS)
    assert plan == gn_plan(b, s, c, 32 if c % 32 == 0 else 8, itemsize, GN_PLAN_SMS)
    assert plan.rows * c * itemsize % 16 == 0
    assert (plan.parts - 1) * plan.rows < s <= plan.parts * plan.rows
    assert plan.blocks == min(b * plan.parts, GN_PLAN_SMS)
    assert -(-b * plan.parts // plan.blocks) == rounds
    assert rounds == 1 or plan.parts == 1
    if b <= GN_PLAN_SMS and s >= 8 * GN_PLAN_SMS:
        # the items fill the SMs once, with at most b - 1 left idle
        assert GN_PLAN_SMS - b < b * plan.parts <= GN_PLAN_SMS
    assert plan.chunk_rows * c * itemsize % 16 == 0
    assert 4 * plan.chunk_rows * c * itemsize <= 4 * 32768  # the ring of 4 chunks
