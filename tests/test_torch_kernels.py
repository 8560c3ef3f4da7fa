"""The port's two kernel modules: BSHD flash attention and fused LayerNorm,
forward and backward.

On the CPU the wrappers return their plain PyTorch versions, which are
held here against the JAX package: the BSHD plain versions against the
Pallas kernels run in interpret mode (as tests/ops/test_flash_attention.py
runs them; the backward through jax.grad), the LayerNorm plain version
against vision_ft_tpu.nn.LayerNorm, whose CPU formula is the kernel's
formula, and the LayerNorm backward against the JAX package's
_layer_norm_bwd.

The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_ft_tpu.nn as jnn
from vision_ft_tpu.ops.attention import attention_heads_packed as jax_attention_heads_packed
from vision_ft_tpu.ops.pallas.flash_attention import flash_attention_bshd as jax_flash_bshd
from vision_ft_tpu.ops.pallas.layer_norm import _layer_norm_bwd as jax_layer_norm_bwd

import vision_ft_tpu_torch.ops.flash_attention as flash_module
from vision_ft_tpu_torch.nn import remat_layer, set_remat_saves
from vision_ft_tpu_torch.ops.attention import attention_heads_packed
from vision_ft_tpu_torch.ops.flash_attention import (
    flash_attention_bshd,
    flash_attention_bshd_backward,
    flash_attention_bshd_dkv,
    flash_attention_bshd_dq,
    flash_attention_bshd_backward_reference,
    flash_attention_bshd_reference,
)
from vision_ft_tpu_torch.ops import layer_norm as layer_norm_module
from vision_ft_tpu_torch.ops.layer_norm import (
    layer_norm,
    layer_norm_backward,
    layer_norm_reference,
    ln_plan,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

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
        (1, 256, 256, 2, 256),  # AuraFlow's head dim (the forward kernel only)
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


@pytest.mark.parametrize(
    "b,sq,sk,h,d",
    [
        (1, 256, 256, 2, 64),  # aligned
        (2, 200, 200, 4, 64),  # ragged self-attention lengths
        (1, 130, 130, 2, 64),
        (1, 200, 300, 2, 64),  # ragged, sq != sk
        (1, 256, 256, 2, 256),  # AuraFlow's head dim
        (1, 130, 200, 2, 256),  # head dim 256, ragged, sq != sk
    ],
)
def test_bshd_plain_backward_matches_jax_kernel(b, sq, sk, h, d):
    """The plain backward (fed the plain forward's out and lse) against
    jax.grad through the Pallas kernels in interpret mode, and against
    torch autograd through the plain forward; the wrapper's autograd
    function takes the plain versions on the CPU and launches nothing."""
    q, k, v = _rand(0, (b, sq, h * d)), _rand(1, (b, sk, h * d)), _rand(2, (b, sk, h * d))
    dout = _rand(3, (b, sq, h * d))
    scale = d**-0.5

    def jax_loss(q, k, v):
        out = jax_flash_bshd(q, k, v, h, scale=scale, interpret=True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tdout = torch.from_numpy(dout)
    with torch.no_grad():
        out, lse = flash_attention_bshd_reference(*leaves, h, scale, return_lse=True)
        plain = flash_attention_bshd_backward_reference(*leaves, out, lse, tdout, h, scale)
    through_plain_forward = torch.autograd.grad(
        (flash_attention_bshd_reference(*leaves, h, scale) * tdout).sum(), leaves
    )
    wrappers = (flash_attention_bshd, flash_attention_bshd_dkv, flash_attention_bshd_dq)
    before = [w.launches for w in wrappers]
    through_wrapper = torch.autograd.grad(
        (flash_attention_bshd(*leaves, h, scale) * tdout).sum(), leaves
    )
    assert [w.launches for w in wrappers] == before
    for name, got, auto, wrapped, ref in zip(
        ("dq", "dk", "dv"), plain, through_plain_forward, through_wrapper, want
    ):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(ref), atol=ATTN_TOL, rtol=ATTN_TOL, err_msg=name
        )
        np.testing.assert_allclose(
            got.numpy(), auto.numpy(), atol=ATTN_TOL, rtol=ATTN_TOL, err_msg=name
        )
        torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_bshd_lse_on_the_cpu():
    q, k, v = (torch.from_numpy(_rand(i, (2, 130, 128))) for i in range(3))
    out, lse = flash_attention_bshd(q, k, v, 2, return_lse=True)
    torch.testing.assert_close(out, flash_attention_bshd(q, k, v, 2), rtol=0, atol=0)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.unflatten(-1, (2, 64)), k.unflatten(-1, (2, 64))
    ) * 64**-0.5
    assert lse.shape == (2, 2, 130) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(scores, -1), atol=1e-5, rtol=1e-5)
    dq, dk, dv = flash_attention_bshd_backward(q, k, v, out, lse, torch.ones_like(out), 2)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


def test_bshd_head_dim_sets():
    """Both BSHD kernels take D 64, 128 and 256 (AuraFlow's 12 heads of
    256); other head dims are refused by the forward's and the backward's
    checks alike, before the tensors' device. D 256 on the CPU is refused
    for the kernels for where it lies, and the CPU's plain backward takes
    it (and any head dim)."""
    for d in (32, 48, 64, 96, 128, 256):
        want = d in (64, 128, 256)
        assert flash_module.supports(12, d) is want and flash_module.supports_backward(12, d) is want
    q = torch.zeros(1, 256, 2 * 96)
    for backward in (False, True):
        with pytest.raises(ValueError, match="head dims"):
            flash_module._check(q, q, q, 2, backward=backward)
    q = torch.zeros(1, 256, 512)
    for backward in (False, True):  # D 256: refused for the CPU, not for its head dim
        with pytest.raises(ValueError, match="bf16 on"):
            flash_module._check(q, q, q, 2, backward=backward)
    leaves = [torch.from_numpy(_rand(i, (1, 40, 512))).requires_grad_() for i in range(3)]
    grads = torch.autograd.grad(flash_attention_bshd(*leaves, 2).sum(), leaves)
    want = torch.autograd.grad(flash_attention_bshd_reference(*leaves, 2).sum(), leaves)
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, atol=FP32_TOL, rtol=FP32_TOL)


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_Z6kernelILi256EEv'
ptxas info    : Compiling entry function '_Z6kernelILi256EEv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi256EEv
    384 bytes stack frame, 852 bytes spill stores, 684 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cumulative stack size
ptxas info    : Compile time = 286.359 ms
ptxas info    : Compiling entry function '_Z6kernelILi64EEv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi64EEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_parses_nvcc_output():
    """The report's parser on nvcc -Xptxas -v's format (an illustrative
    sample: two kernels, one spilling with a serialization note)."""
    from vision_ft_tpu_torch.tools.ptxas_report import main, parse

    assert parse(PTXAS_SAMPLE) == {
        "_Z6kernelILi256EEv": dict(notes=["C7520"], stack=384, spill_stores=852, spill_loads=684,
                                   registers=168),
        "_Z6kernelILi64EEv": dict(notes=[], stack=0, spill_stores=0, spill_loads=0, registers=168),
    }
    assert main([]) == 2


@pytest.mark.parametrize("mode,forwards", [("activations", 1), ("kernel", 1), ("none", 2)])
def test_remat_keeps_or_reruns_the_flash_forward(monkeypatch, mode, forwards):
    """A checkpointed region runs the attention forward once with the
    "kernel" saves and twice with none; the gradients do not change."""
    calls = []
    forward = flash_module._forward
    monkeypatch.setattr(
        flash_module, "_forward", lambda *a, **kw: calls.append(1) or forward(*a, **kw)
    )
    leaves = [torch.from_numpy(_rand(i, (1, 130, 128))).requires_grad_() for i in range(3)]

    def region(q, k, v):
        first = flash_attention_bshd(q * 1.5, k, v, 2)
        return flash_attention_bshd(first, k * 0.5, v, 2).sin()

    want = torch.autograd.grad(region(*leaves).sum(), leaves)
    calls.clear()
    set_remat_saves(mode)
    try:
        loss = remat_layer(region)(*leaves).sum()
        got = torch.autograd.grad(loss, leaves, retain_graph=True)
        assert len(calls) == 2 * forwards
        again = torch.autograd.grad(loss, leaves)  # a second walk recomputes again
    finally:
        set_remat_saves("activations")
    assert len(calls) == 2 * forwards + 2 * (forwards - 1)
    for g, a, w in zip(got, again, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_remat_activations_mode_is_not_ported():
    """"activations" is ported now and is the default, as in the JAX
    package (its gradients are held in tests/test_torch_remat.py); the
    remat groups are ported (held against the JAX package in
    tests/test_torch_lumina2_train.py)."""
    from vision_ft_tpu_torch.config import TrainerConfig
    from vision_ft_tpu_torch.nn.core import remat_group, remat_saves, run_remat_stack, set_remat_group

    assert TrainerConfig().remat_saves == "activations" == remat_saves()
    set_remat_saves("activations")
    assert remat_saves() == "activations"
    with pytest.raises(ValueError):
        set_remat_group(0)
    assert remat_group() == 1
    assert run_remat_stack(lambda layer, c: c * layer, [2.0, 3.0], torch.ones(2), False).tolist() == [6, 6]
    with pytest.raises(ValueError):
        set_remat_saves("everything")


@pytest.mark.parametrize("shape,c,bias", [((6, 11), 640, True), ((154,), 768, True), ((9,), 1280, False)])
def test_layer_norm_backward_matches_jax(shape, c, bias):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((*shape, c)) * 2 + 0.3).astype(np.float32)
    dy = rng.standard_normal((*shape, c)).astype(np.float32)
    gamma = rng.normal(1, 0.2, (c,)).astype(np.float32)
    beta = rng.normal(0, 0.2, (c,)).astype(np.float32) if bias else None
    want = jax_layer_norm_bwd(
        1e-5,
        (jnp.asarray(x), jnp.asarray(gamma), None if beta is None else jnp.asarray(beta)),
        jnp.asarray(dy),
    )
    tx, tgamma = torch.from_numpy(x).requires_grad_(), torch.from_numpy(gamma).requires_grad_()
    tbeta = torch.from_numpy(beta).requires_grad_() if bias else None
    got = layer_norm_backward(tx, tgamma, tbeta, torch.from_numpy(dy), 1e-5)
    leaves = (tx, tgamma, tbeta) if bias else (tx, tgamma)
    through_wrapper = torch.autograd.grad(
        (layer_norm(tx, tgamma, tbeta, 1e-5) * torch.from_numpy(dy)).sum(), leaves
    )
    assert (got[2] is None) == (want[2] is None) == (not bias)
    for name, g, w, auto in zip(("dx", "dgamma", "dbeta"), got, want, through_wrapper):
        # dgamma/dbeta sum up to 154 rows of O(1) terms in another order
        np.testing.assert_allclose(
            g.detach().numpy(), np.asarray(w), atol=FP32_TOL, rtol=FP32_TOL, err_msg=name
        )
        torch.testing.assert_close(auto, g.detach(), rtol=0, atol=0)


def test_layer_norm_backward_skips_a_frozen_affine():
    x = torch.from_numpy(_rand(8, (5, 256))).requires_grad_()
    weight, bias = torch.ones(256), torch.zeros(256)
    dx, dgamma, dbeta = layer_norm_backward(x, weight, bias, torch.ones(5, 256), affine_grads=False)
    assert dgamma is None and dbeta is None and dx.shape == x.shape
    (auto,) = torch.autograd.grad(layer_norm(x, weight, bias).square().sum(), x)
    (plain,) = torch.autograd.grad(layer_norm_reference(x, weight, bias).square().sum(), x)
    torch.testing.assert_close(auto, plain, atol=FP32_TOL, rtol=FP32_TOL)


# (rows, C) of kernel A's plan: the SDXL request's and train step's shapes,
# one row, C not a multiple of 8 or of 256, and the widest C it takes
LN_PLAN_SHAPES = [(8192, 640), (2048, 1280), (154, 768), (16384, 640), (1, 8), (7, 136),
                  (3, 2049), (5, 4100), (1, 8192), (100000, 8192), (10**6, 1)]


@pytest.mark.parametrize("rows,c", LN_PLAN_SHAPES)
def test_ln_plan_covers_every_row_and_element_once(rows, c):
    """Kernel A's launch plan, walked as ``csrc/layer_norm.cu`` walks it:
    block b takes groups b, b + blocks, ... of rows_per_block rows; warp w
    takes row slot w // wpr of a group and vectors (i * wpr + w % wpr) * 32 +
    lane of it. Every row and every 8-element vector of a row is reached
    once, and the grid and the registers stay within the card's limits."""
    sms = 132
    plan = ln_plan(rows, c, sms)
    wpr, vpl, per_block, blocks = plan
    assert wpr in (1, 2, 4) and per_block * wpr == 4 and 1 <= vpl <= 8
    assert 1 <= blocks <= min(sms * 16, 2**31 - 1)
    groups = -(-rows // per_block)
    assert blocks == min(groups, sms * 16)
    reached = np.zeros(rows, np.int64)
    for b in range(blocks):
        for slot in range(per_block):
            row = np.arange(b, groups, blocks) * per_block + slot
            np.add.at(reached, row[row < rows], 1)
    assert (reached == 1).all()
    vectors = -(-c // 8)
    cols = np.array([(i * wpr + part) * 32 + lane
                     for part in range(wpr) for lane in range(32) for i in range(vpl)])
    assert sorted(cols[cols < vectors]) == list(range(vectors))
    if wpr > 1:  # the fewest warps a row: one warp fewer would need over 8 vectors a lane
        assert (wpr // 2) * 32 * 8 < vectors


def test_row_layout_reaches_every_row_of_a_strided_view():
    """The rows the kernel reaches through (inner, batch_stride, row_stride)
    are x's own rows: a contiguous x, a batch of row slices, an NHWC slice
    whose spatial axes fold into one, a single batch row; a transposed or
    unfoldable view has no layout (the wrapper raises)."""
    base = torch.arange(4 * 9 * 5 * 16, dtype=torch.float32).reshape(4, 9, 5, 16)
    views = [base, base[:, 2:7], base[1:3, :, :, :], base[:, 3:4, 1:2],
             base.reshape(36, 80)[::3].unflatten(-1, (5, 16)), base[2, 1:6, 4]]
    for x in views:
        inner, batch_stride, row_stride = layer_norm_module._row_layout(x)
        rows = x.numel() // x.shape[-1]
        starts = [(r // inner) * batch_stride + (r % inner) * row_stride for r in range(rows)]
        flat = base.reshape(-1)
        got = torch.stack([flat[x.storage_offset() + s:][: x.shape[-1]] for s in starts])
        torch.testing.assert_close(got, x.reshape(rows, x.shape[-1]), rtol=0, atol=0)
    assert layer_norm_module._row_layout(base.transpose(-1, -2)) is None
    assert layer_norm_module._row_layout(base[:, :, 1:4]) is None  # rows 80 apart, then 16
