"""The fused gated MLP of the port, on the CPU.

On a CPU tensor the wrappers return the plain PyTorch version, held here
against the JAX package's Pallas kernel run in interpret mode
(``gated_mlp`` / ``geglu_mlp(..., interpret=True)``) and its ``_gated_ref``;
the plain versions of kernel F's two parts (F-up, F-down) composed against
the whole call and the JAX kernel; the autograd function against
``jax.grad`` through the JAX package's ``custom_vjp``; the gate
(``supported``, ``fused_ff_enabled``, ``set_fused_ff``) and F-down's split
rule case by case. The kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda_kernels.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.ops.pallas import fused_mlp as jax_fused

import vision_ft_tpu_torch.nn as tnn
from vision_ft_tpu_torch.modules import peft, quant
from vision_ft_tpu_torch.ops import fused_mlp
from vision_ft_tpu_torch.ops.fused_mlp import (
    down_splits,
    fused_ff_enabled,
    gated_down,
    gated_down_reference,
    gated_mlp,
    gated_mlp_reference,
    gated_up,
    gated_up_reference,
    geglu_mlp,
    set_fused_ff,
    supported,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU: both sides sum 128 to 512 products of O(1) terms in fp32,
# in another order (the Pallas kernel by inner chunks); relative to the
# output's largest value
FP32_TOL = 2e-5


def _weights(seed, m, c, inner, biases, lead=()):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    x = f(*lead, m, c)
    wa, wg, wd = f(inner, c) * c**-0.5, f(inner, c) * c**-0.5, f(c, inner) * inner**-0.5
    ba, bg, bd = (f(n) * 0.1 if biases else None for n in (inner, inner, c))
    return x, wa, wg, wd, ba, bg, bd


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=FP32_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * np.abs(want).max(), rtol=tol)


@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "gelu"])
@pytest.mark.parametrize("biases", [True, False], ids=["biases", "no_biases"])
@pytest.mark.parametrize("m", [256, 37], ids=["aligned", "ragged"])
def test_gated_mlp_plain_matches_jax_kernel(act, biases, m):
    x, wa, wg, wd, ba, bg, bd = _weights(0, m, 128, 512, biases)
    want = jax_fused.gated_mlp(
        _j(x), _j(wa), _j(wg), _j(wd), _j(ba), _j(bg), _j(bd), act=act, interpret=True
    )
    zeros = lambda b, n: jnp.zeros((n,), jnp.float32) if b is None else _j(b)  # noqa: E731
    oracle = jax_fused._gated_ref(
        _j(x), _j(wa), zeros(ba, 512), _j(wg), zeros(bg, 512), _j(wd), zeros(bd, 128), act
    )
    plain = gated_mlp_reference(_t(x), _t(wa), _t(wg), _t(wd), _t(ba), _t(bg), _t(bd), act)
    _close(plain.numpy(), want)
    _close(plain.numpy(), oracle)
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = gated_mlp.launches
    got = gated_mlp(_t(x), _t(wa), _t(wg), _t(wd), _t(ba), _t(bg), _t(bd), act)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert gated_mlp.launches == before


@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "gelu"])
@pytest.mark.parametrize("biases", [True, False], ids=["biases", "no_biases"])
def test_up_then_down_is_the_whole_call(act, biases):
    """Kernel F's two parts, F-up then F-down, as plain versions: their
    composition is the whole call's plain version bit for bit, and the JAX
    package's interpreted kernel within FP32_TOL, at a ragged row count. On
    CPU tensors the parts' wrappers are their plain versions."""
    x, wa, wg, wd, ba, bg, bd = _weights(7, 45, 128, 512, biases)
    a = gated_up_reference(_t(x), _t(wa), _t(wg), _t(ba), _t(bg), act)
    assert a.shape == (45, 512) and a.dtype == torch.float32
    composed = gated_down_reference(a, _t(wd), _t(bd))
    whole = gated_mlp_reference(_t(x), _t(wa), _t(wg), _t(wd), _t(ba), _t(bg), _t(bd), act)
    assert torch.equal(composed, whole)
    want = jax_fused.gated_mlp(
        _j(x), _j(wa), _j(wg), _j(wd), _j(ba), _j(bg), _j(bd), act=act, interpret=True
    )
    _close(composed.numpy(), want)
    before = (gated_up.launches, gated_down.launches)
    assert torch.equal(gated_up(_t(x), _t(wa), _t(wg), _t(ba), _t(bg), act), a)
    assert torch.equal(gated_down(a, _t(wd), _t(bd)), composed)
    assert (gated_up.launches, gated_down.launches) == before


def test_up_then_down_is_geglu():
    """GeGLU's halves through F-up's plain version (linear stream from the
    second half, gelu gate from the first), then F-down's, against the JAX
    package's interpreted ``geglu_mlp``."""
    rng = np.random.default_rng(8)
    c, inner = 128, 256
    x = rng.standard_normal((61, c)).astype(np.float32)
    w1 = (rng.standard_normal((2 * inner, c)) * c**-0.5).astype(np.float32)
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((c, inner)) * inner**-0.5).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    tw1, tb1 = _t(w1), _t(b1)
    a = gated_up_reference(_t(x), tw1[inner:], tw1[:inner], tb1[inner:], tb1[:inner], "gelu_tanh")
    got = gated_down_reference(a, _t(w2), _t(b2))
    assert torch.equal(got, geglu_mlp(_t(x), tw1, tb1, _t(w2), _t(b2)))
    _close(got.numpy(), jax_fused.geglu_mlp(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), interpret=True))


@pytest.mark.parametrize(
    "m,c,inner,sms,want",
    [
        (8704, 2304, 9216, 132, 1),   # the main stack: 612 output tiles fill the card
        (512, 2304, 9216, 132, 3),    # the context refiner: 36 tiles, 3 parts of 48 K tiles
        (1001, 1280, 5120, 132, 3),   # 40 tiles of 128 x 256
        (1001, 640, 2560, 132, 2),    # C % 256 != 0: 128-wide tiles, 40 of them; 2 parts of 20
        (64, 4096, 8192, 132, 8),     # 16 tiles, 8 parts of 16 K tiles
        (1, 128, 256, 132, 1),        # 4 K tiles: too shallow to split
        (512, 2304, 9216, 16, 1),     # a card with fewer SMs than tiles
    ],
)
def test_down_splits(m, c, inner, sms, want):
    """F-down splits inner only where its output tiles leave SMs idle, and
    never below 16 K tiles a part."""
    assert down_splits(m, c, inner, sms) == want
    tiles = -(-m // 128) * (c // (256 if c % 256 == 0 else 128))
    assert want == 1 or want * tiles <= sms
    assert want == 1 or inner // 64 // want >= 16


def test_gated_mlp_keeps_leading_axes():
    x, wa, wg, wd, *_ = _weights(1, 50, 128, 256, False, lead=(2,))
    want = jax_fused.gated_mlp(_j(x), _j(wa), _j(wg), _j(wd), interpret=True)
    got = gated_mlp(_t(x), _t(wa), _t(wg), _t(wd))
    assert got.shape == (2, 50, 128)
    _close(got.numpy(), want)


@pytest.mark.parametrize("m", [128, 77])
def test_geglu_mlp_matches_jax_kernel(m):
    """The fused (2*inner, C) up-projection read by halves: first half the
    linear stream, second half the gelu gate."""
    rng = np.random.default_rng(2)
    c, inner = 128, 256
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((2 * inner, c)) * c**-0.5).astype(np.float32)
    b1 = (rng.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((c, inner)) * inner**-0.5).astype(np.float32)
    b2 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    want = jax_fused.geglu_mlp(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), interpret=True)
    oracle = jax_fused._geglu_ref(_j(x), _j(w1), _j(b1), _j(w2), _j(b2))
    got = geglu_mlp(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    _close(got.numpy(), want)
    _close(got.numpy(), oracle)
    hidden = torch.from_numpy(x) @ torch.from_numpy(w1).T + torch.from_numpy(b1)
    by_hand = (hidden[:, :inner] * torch.nn.functional.gelu(hidden[:, inner:], approximate="tanh")
               ) @ torch.from_numpy(w2).T + torch.from_numpy(b2)
    _close(got.numpy(), by_hand.numpy())


@pytest.mark.parametrize("act", ["silu", "gelu_tanh", "gelu"])
@pytest.mark.parametrize("biases", [True, False], ids=["biases", "no_biases"])
def test_gated_mlp_gradients_match_jax(act, biases):
    """The autograd function's backward (the plain formula) against
    jax.grad through the JAX package's custom_vjp, for every input."""
    x, wa, wg, wd, ba, bg, bd = _weights(3, 40, 128, 256, biases)
    dout = np.random.default_rng(4).standard_normal((40, 128)).astype(np.float32)
    present = [a for a in (x, wa, wg, wd, ba, bg, bd) if a is not None]

    def jax_loss(*args):
        if biases:
            x, wa, wg, wd, ba, bg, bd = args
        else:
            (x, wa, wg, wd), ba, bg, bd = args, None, None, None
        out = jax_fused.gated_mlp(x, wa, wg, wd, ba, bg, bd, act=act, interpret=True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jax_loss, argnums=tuple(range(len(present))))(*(jnp.asarray(a) for a in present))
    leaves = [torch.from_numpy(a).requires_grad_() for a in present]
    tx, twa, twg, twd = leaves[:4]
    tba, tbg, tbd = leaves[4:] if biases else (None, None, None)
    out = gated_mlp(tx, twa, twg, twd, tba, tbg, tbd, act)
    assert out.requires_grad
    got = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), leaves)
    for name, g, w in zip(("x", "wa", "wg", "wd", "ba", "bg", "bd"), got, want):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), atol=FP32_TOL * float(np.abs(np.asarray(w)).max()) + 1e-6,
            rtol=1e-4, err_msg=name,
        )


def test_geglu_gradient_reaches_both_halves_and_skips_frozen_weights():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9, 128)).astype(np.float32)).requires_grad_()
    w1 = torch.from_numpy(rng.standard_normal((512, 128)).astype(np.float32) * 0.1).requires_grad_()
    b1 = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32) * 0.1)
    out = geglu_mlp(x, w1, b1, w2, None)
    dx, dw1 = torch.autograd.grad(out.square().sum(), (x, w1))
    hidden = x @ w1.T + b1
    want = ((hidden[:, :256] * torch.nn.functional.gelu(hidden[:, 256:], approximate="tanh")) @ w2.T)
    want_dx, want_dw1 = torch.autograd.grad(want.square().sum(), (x, w1))
    torch.testing.assert_close(dx, want_dx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(dw1, want_dw1, atol=1e-4, rtol=1e-4)
    assert dw1[:256].abs().sum() > 0 and dw1[256:].abs().sum() > 0
    assert w2.grad is None and b1.grad is None


@pytest.mark.parametrize(
    "c,inner,want",
    [
        (2304, 9216, True), (640, 2560, True), (1280, 5120, True), (3072, 8192, True),
        (128, 256, True), (2304 + 64, 9216, False), (2304, 9216 + 128, False), (100, 256, False),
        (3712, 8192, True), (3840, 8192, True),
    ],
)
def test_supported(c, inner, want):
    """The JAX package's rule, exactly: kernel F has no cap on c."""
    assert supported(c, inner) is want
    assert jax_fused.supported(c, inner) is want


def test_unknown_activation_raises():
    x, wa, wg, wd, *_ = (_t(a) for a in _weights(6, 4, 128, 256, False))
    with pytest.raises(ValueError):
        gated_mlp(x, wa, wg, wd, act="relu")


def _ff_layers(dtype=torch.bfloat16, inner=9216, c=128):
    layers = [tnn.Linear(c, inner, bias=False), tnn.Linear(inner, c, bias=False),
              tnn.Linear(c, inner, bias=False)]
    g = torch.Generator().manual_seed(0)
    for layer in layers:
        tnn.init_parameters_(layer, g)
        layer.to(dtype)
    return layers


def _on_card(dtype=torch.bfloat16, is_cuda=True):
    """What ``fused_ff_enabled`` reads of the activations."""
    return types.SimpleNamespace(dtype=dtype, is_cuda=is_cuda)


@pytest.mark.parametrize(
    "mode,inner,x,change,want",
    [
        ("auto", 9216, _on_card(), None, True),            # Lumina2's inner width
        ("auto", 8192, _on_card(), None, True),
        ("auto", 5120, _on_card(), None, False),           # SDXL widths stay plain in "auto"
        ("auto", None, _on_card(), None, False),
        ("on", 5120, _on_card(), None, True),
        ("off", 9216, _on_card(), None, False),
        ("auto", 9216, _on_card(torch.float32), None, False),
        ("auto", 9216, _on_card(is_cuda=False), None, False),  # CPU tensors: the plain route
        ("on", 9216, _on_card(), "lora", False),
        ("on", 9216, _on_card(), "loha", False),
        ("on", 9216, _on_card(), "nf4", False),
        ("on", 9216, _on_card(), "fp8", False),
        ("on", 9216, _on_card(), "fp32_weight", False),
    ],
)
def test_fused_ff_enabled_cases(mode, inner, x, change, want):
    layers = _ff_layers(inner=256 if change else 64)
    holder = torch.nn.ModuleDict({"w1": layers[0], "w2": layers[1], "w3": layers[2]})
    g = torch.Generator().manual_seed(1)
    if change == "lora":
        peft.replace_to_peft_layer(holder, ["w2"], [], peft.LoRAConfig(rank=4, alpha=4.0), g)
    elif change == "loha":
        peft.replace_to_peft_layer(holder, ["w3"], [], peft.LoHaConfig(rank=4, alpha=4.0), g)
    elif change == "nf4":
        quant.quantize_params(holder, "bnb_nf4", ["w1"])
    elif change == "fp8":
        layers[1].set_quantized_weight(layers[1].weight.detach().to(torch.float8_e4m3fn))
    elif change == "fp32_weight":
        layers[2].to(torch.float32)
    set_fused_ff(mode)
    try:
        assert fused_mlp.fused_ff() == mode
        assert fused_ff_enabled(x, *layers, inner=inner) is want
    finally:
        set_fused_ff("auto")


def test_set_fused_ff_rejects_unknown_modes():
    with pytest.raises(ValueError):
        set_fused_ff("1")
    assert fused_mlp.fused_ff() == "auto"
