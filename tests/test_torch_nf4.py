"""The port's NF4 / FP4 format, its packed 4-bit matmul and its panel
stream against the JAX package (CPU).

Inputs are made with numpy from a seed and handed to both packages. On
the CPU the port's kernel wrappers take their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_ft_tpu.modules.quant import nf4 as jax_nf4
from vision_ft_tpu.ops import nf4_stream as jax_stream
from vision_ft_tpu.ops.pallas import nf4_matmul as jax_fused

from vision_ft_tpu_torch.modules.quant import nf4
from vision_ft_tpu_torch.ops import nf4_matmul as fused
from vision_ft_tpu_torch.ops import nf4_stream as stream
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# bf16 kernels against plain dequantization: the output's bf16 rounding and
# fp32 sums in another order, relative to the output's largest value (the
# JAX package's own tolerances for these kernels)
FWD_TOL, DX_TOL = 2e-2, 3e-2
SHAPES = [(64, 256, 128), (100, 512, 256), (32, 1280, 384)]  # (m, k, n)


def _weight(shape, seed=0, scale=0.02):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16(array):
    """numpy fp32 -> (jax bf16, torch bf16) of the same bits."""
    j = jnp.asarray(array).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return j, t


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _quantized(n, k, quant_type="nf4", split=False, seed=0):
    """(numpy packed, code, absmax) from the JAX package's quantizer."""
    packed, state = jax_nf4.quantize_4bit(_weight((n, k), seed), quant_type=quant_type)
    if split:
        packed = jax_fused.to_split_layout(packed, (n, k))
    return packed, state["quant_map"], state["absmax"]


@pytest.mark.parametrize("shape", [(64, 128), (10, 7), (32, 256)], ids=str)
@pytest.mark.parametrize("compress", [False, True], ids=["plain", "nested"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_quantize_4bit_is_byte_equal_to_jax(quant_type, compress, shape):
    w = _weight(shape, seed=1)
    want_packed, want_state = jax_nf4.quantize_4bit(w, quant_type, compress_statistics=compress)
    packed, state = nf4.quantize_4bit(torch.from_numpy(w), quant_type, compress_statistics=compress)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == want_packed.shape
    np.testing.assert_array_equal(packed.numpy(), want_packed)
    assert list(state) == list(want_state)
    for key, value in want_state.items():
        assert state[key].numpy().dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(value), err_msg=key)
    parsed, want_parsed = nf4.parse_quant_state(state), jax_nf4.parse_quant_state(want_state)
    assert {k: parsed[k] for k in ("quant_type", "blocksize", "shape")} == {
        k: want_parsed[k] for k in ("quant_type", "blocksize", "shape")
    }
    # the un-double-quantized absmax: value * scale + offset, fp32 (one ulp
    # where a compiler fuses the multiply and the add)
    np.testing.assert_allclose(parsed["absmax"].numpy(), np.asarray(want_parsed["absmax"]), rtol=2e-7)
    np.testing.assert_array_equal(parsed["code"].numpy(), np.asarray(want_parsed["code"]))


def test_codebooks_equal_jax():
    np.testing.assert_array_equal(nf4.NF4_CODE, jax_nf4.NF4_CODE)
    np.testing.assert_array_equal(nf4.FP4_CODE, jax_nf4.FP4_CODE)
    np.testing.assert_array_equal(nf4.DYNAMIC_MAP, jax_nf4.DYNAMIC_MAP)
    np.testing.assert_array_equal(nf4.create_dynamic_map(signed=False), jax_nf4.create_dynamic_map(signed=False))
    for numel, blocks in [(70, 2), (8192, 128), (8192, 64), (70, 1)]:
        assert nf4.infer_blocksize(numel, blocks) == jax_nf4.infer_blocksize(numel, blocks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [False, True], ids=["bnb", "split"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
def test_dequantize_4bit_equals_jax(quant_type, split, dtype):
    n, k = 48, 256
    packed, code, absmax = _quantized(n, k, quant_type, split, seed=2)
    want = jax_nf4.dequantize_4bit(
        jnp.asarray(packed), jnp.asarray(code), jnp.asarray(absmax), (n, k), 64,
        getattr(jnp, dtype), split=split,
    )
    got = nf4.dequantize_4bit(
        torch.from_numpy(packed), torch.from_numpy(code), torch.from_numpy(absmax), (n, k), 64,
        getattr(torch, dtype), split=split,
    )
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (n, k)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_dequantize_4bit_padded_odd_shape_and_split_errors():
    w = _weight((10, 7), seed=3, scale=1.0)
    packed, state = jax_nf4.quantize_4bit(w, "nf4")
    want = jax_nf4.dequantize_4bit(
        jnp.asarray(packed), jnp.asarray(state["quant_map"]), jnp.asarray(state["absmax"]), (10, 7)
    )
    got = nf4.dequantize_4bit(
        torch.from_numpy(packed), torch.from_numpy(state["quant_map"]),
        torch.from_numpy(state["absmax"]), (10, 7),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="split layout"):
        nf4.dequantize_4bit(
            torch.from_numpy(packed), torch.from_numpy(state["quant_map"]),
            torch.from_numpy(state["absmax"]), (10, 7), split=True,
        )
    with pytest.raises(ValueError):
        nf4.quantize_4bit(torch.from_numpy(w), "int4")


@pytest.mark.parametrize("shape", [(128, 512), (6, 10), (10, 6)], ids=str)
def test_split_layout_round_trip_and_equals_jax(shape):
    n, k = shape
    rng = np.random.default_rng(7)
    # bnb bytes with their flat padding to a 64-element block
    packed = rng.integers(0, 256, (-(-n * k // 64) * 32, 1), dtype=np.uint8)
    want = jax_fused.to_split_layout(packed, shape)
    got = fused.to_split_layout(torch.from_numpy(packed), shape)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, k // 2)
    np.testing.assert_array_equal(got.numpy(), want)
    back = fused.from_split_layout(got, shape)
    np.testing.assert_array_equal(back.numpy(), jax_fused.from_split_layout(want, shape))
    np.testing.assert_array_equal(back.numpy().reshape(-1), packed.reshape(-1)[: n * k // 2])
    with pytest.raises(ValueError, match="even"):
        fused.to_split_layout(torch.from_numpy(packed), (k, n + 1) if (n + 1) % 2 else (k, n - 1))


def test_supports_contains_the_jax_contract():
    for m, k, n, blocksize in [(8, 192, 128, 64), (8, 256, 96, 64), (8, 256, 128, 128),
                               (1, 10240, 1280, 64), (908, 2048, 640, 64), (16384, 640, 5120, 64)]:
        if jax_fused.supports(m, k, n, blocksize):
            assert fused.supports(m, k, n, blocksize)
    assert fused.supports(16384, 640, 640, 64) and not jax_fused.supports(16384, 640, 640, 64)
    assert not fused.supports(8, 192, 128, 64)   # k % 128
    assert not fused.supports(8, 256, 96, 64)    # n % 128
    assert not fused.supports(8, 256, 128, 128)  # blocksize
    assert not fused.supports(0, 256, 128, 64)


@pytest.mark.parametrize(
    "m,k,n,dx,sms,want",
    [
        (4096, 1280, 1280, False, 132, 1),   # 320 tiles fill the card
        (908, 2048, 1280, False, 132, 1),    # 80 tiles: two parts would leave SMs idle
        (908, 2048, 640, False, 132, 3),     # 40 tiles, 16 steps
        (154, 2048, 1280, False, 132, 4),    # 20 tiles, 16 steps: 4 a part at least
        (154, 2048, 1280, True, 132, 2),     # dx: 32 tiles, 10 steps of 128 W rows
        (64, 640, 640, True, 132, 1),        # 5 steps: too shallow to split
        (64, 640, 2560, True, 132, 5),       # dx: 5 tiles, 20 steps
        (154, 2048, 1280, False, 16, 1),     # a card with fewer SMs than tiles
    ],
)
def test_contraction_splits(m, k, n, dx, sms, want):
    """The kernels split the contraction only where their output tiles
    leave SMs idle, and never below MIN_SPLIT_STAGES steps a part."""
    stages = fused.contraction_stages(k, n, dx)
    assert stages == (n if dx else k) // 128
    p = k if dx else n
    assert fused.contraction_splits(m, p, stages, sms) == want
    tiles = -(-m // 128) * (p // 128)
    assert want == 1 or want * tiles <= sms
    assert want == 1 or stages // want >= fused.MIN_SPLIT_STAGES


@pytest.mark.parametrize("split", [False, True], ids=["bnb", "split"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_nf4_matmul_and_gradient_match_the_pallas_kernels(m, k, n, split):
    """bf16: the plain versions against the Pallas forward and dx kernels in
    interpret mode, within the kernels' own tolerances."""
    assert fused.supports(m, k, n, 64) and jax_fused.supports(m, k, n, 64)
    packed, code, absmax = _quantized(n, k, split=split)
    rng = np.random.default_rng(11)
    jx, tx = _bf16(rng.standard_normal((m, k)).astype(np.float32))
    jco, tco = _bf16(rng.standard_normal((m, n)).astype(np.float32))
    jq = (jnp.asarray(packed), jnp.asarray(code), jnp.asarray(absmax))

    def f(x):
        y = jax_fused.nf4_matmul(x, *jq, (n, k), interpret=True, split=split)
        return (y * jco).sum().astype(jnp.float32), y

    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jx)
    tx.requires_grad_()
    tq = (torch.from_numpy(packed), torch.from_numpy(code), torch.from_numpy(absmax))
    got = fused.nf4_matmul(tx, *tq, (n, k), split=split)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    got_dx, = torch.autograd.grad((got * tco).sum(), tx)
    assert got_dx.shape == (m, k) and got_dx.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FWD_TOL * np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got_dx), _np(want_dx), rtol=0, atol=DX_TOL * np.abs(_np(want_dx)).max())


@pytest.mark.parametrize("split", [False, True], ids=["bnb", "split"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_nf4_matmul_and_gradient_match_jax_dequant_in_fp32(m, k, n, split):
    """fp32: the same function as the JAX package's dequantize-then-matmul,
    up to the order of fp32 sums."""
    packed, code, absmax = _quantized(n, k, split=split, seed=5)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, k)).astype(np.float32)
    co = rng.standard_normal((m, n)).astype(np.float32)

    def f(x):
        w = jax_nf4.dequantize_4bit(
            jnp.asarray(packed), jnp.asarray(code), jnp.asarray(absmax), (n, k), 64, jnp.float32, split
        )
        y = jnp.matmul(x, w.T, precision="highest")
        return (y * co).sum(), y

    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tq = (torch.from_numpy(packed), torch.from_numpy(code), torch.from_numpy(absmax))
    got = fused.nf4_matmul(tx, *tq, (n, k), split=split)
    got_dx, = torch.autograd.grad((got * torch.from_numpy(co)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5 * np.abs(want_dx).max())


def test_nf4_matmul_fp4_leading_dims_and_frozen_base():
    b, s, k, n = 2, 24, 256, 128
    packed, code, absmax = _quantized(n, k, quant_type="fp4", seed=6)
    jx, tx = _bf16(np.random.default_rng(3).standard_normal((b, s, k)).astype(np.float32))
    want = jax_fused.nf4_matmul(
        jx, jnp.asarray(packed), jnp.asarray(code), jnp.asarray(absmax), (n, k), interpret=True
    )
    t_absmax = torch.from_numpy(absmax).requires_grad_()
    # a non-contiguous input of the same values
    tx = tx.transpose(0, 1).contiguous().transpose(0, 1).requires_grad_()
    assert not tx.is_contiguous()
    got = fused.nf4_matmul(tx, torch.from_numpy(packed), torch.from_numpy(code), t_absmax, (n, k))
    assert got.shape == (b, s, n)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=FWD_TOL * np.abs(_np(want)).max())
    dx, d_absmax = torch.autograd.grad(got.float().sum(), (tx, t_absmax), allow_unused=True)
    assert dx.shape == tx.shape and d_absmax is None  # the base is frozen
    with torch.no_grad():
        assert not fused.nf4_matmul(
            tx, torch.from_numpy(packed), torch.from_numpy(code), t_absmax, (n, k)
        ).requires_grad
    assert fused.nf4_matmul_forward.launches == 0 and fused.nf4_matmul_dx.launches == 0


def _small_panels(monkeypatch, k, rows=128):
    """Both packages stream in panels of ``rows`` output rows."""
    monkeypatch.setattr(stream, "_PANEL_BYTES", rows * 2 * k)
    monkeypatch.setattr(jax_stream, "_PANEL_BYTES", rows * 2 * k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n,panels", [(64, 256, 128, 1), (100, 512, 256, 1), (24, 192, 512, 4)])
def test_stream_matmul_and_gradient_match_jax(monkeypatch, m, k, n, panels, dtype):
    assert stream.supports(n, k, 64) == jax_stream.supports(n, k, 64) is True
    if panels > 1:
        _small_panels(monkeypatch, k)
    assert stream.pick_panel(n, k) == jax_stream.pick_panel(n, k) == n // panels
    packed, code, absmax = _quantized(n, k, split=True, seed=8)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((m, k)).astype(np.float32)
    co = rng.standard_normal((m, n)).astype(np.float32)
    if dtype == "bfloat16":
        (jx, tx), (jco, tco) = _bf16(x), _bf16(co)
        tol_y, tol_dx = FWD_TOL, DX_TOL
    else:
        jx, tx, jco, tco = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(co), torch.from_numpy(co)
        tol_y = tol_dx = 1e-5
    jq = (jnp.asarray(packed), jnp.asarray(code), jnp.asarray(absmax))

    def f(x):
        y = jax_stream.nf4_stream_matmul(x, *jq, (n, k))
        return (y * jco).sum().astype(jnp.float32), y

    (_, want), want_dx = jax.value_and_grad(f, has_aux=True)(jx)
    tx.requires_grad_()
    got = stream.nf4_stream_matmul(
        tx, torch.from_numpy(packed), torch.from_numpy(code), torch.from_numpy(absmax), (n, k)
    )
    got_dx, = torch.autograd.grad((got * tco).sum(), tx)
    assert got.dtype == tx.dtype and got_dx.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol_y * np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got_dx), _np(want_dx), rtol=0, atol=tol_dx * np.abs(_np(want_dx)).max())


@pytest.mark.parametrize(
    "n,k,jax_divides_by_zero",
    [(100, 64, True), (8200, 8192, True), (200, 128, False), (8192, 8192, False),
     (1280, 5120, False), (384, 64, False)],
)
def test_pick_panel(n, k, jax_divides_by_zero):
    """Equal to the JAX package's where that one returns; n itself where n
    is no multiple of 128, also where the JAX loop (n below 128, or above
    one panel) walks its panel down to 0 and divides by it."""
    bn = stream.pick_panel(n, k)
    assert n % bn == 0 and (bn % 128 == 0 if n % 128 == 0 else bn == n)
    if jax_divides_by_zero:
        with pytest.raises(ZeroDivisionError):
            jax_stream.pick_panel(n, k)
    else:
        assert bn == jax_stream.pick_panel(n, k)
