"""The port's 3x3 conv (``ops/conv3x3.py``) against the JAX package's
``conv3x3_tpu``, its Pallas body run on the CPU under
``force_tpu_interpret_mode()``, and its custom VJP (``jax.vjp``). On the
CPU the port's wrapper takes its plain version; kernel K itself is held
against that in ``tests/test_torch_cuda_kernels.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vision_ft_tpu.ops.pallas.conv3x3 import conv3x3_supported as jax_supported
from vision_ft_tpu.ops.pallas.conv3x3 import conv3x3_tpu

from vision_ft_tpu_torch.ops.conv3x3 import (
    MAX_SPLITS,
    conv3x3,
    conv3x3_backward,
    conv3x3_reference,
    conv3x3_supported,
    conv_plan,
    conv_splits,
    pixel_box,
    repack_weight,
)
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)

# fp32 on the CPU: 9 * C products summed in other orders (nine tap
# matmuls on the JAX side, one convolution here), relative to the
# largest value of the output or gradient
TOL = 1e-5

SHAPES = [((1, 8, 8, 16), 32), ((2, 9, 9, 32), 16)]  # the second with odd H = W


def _inputs(shape, co, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((co, shape[-1], 3, 3)) / np.sqrt(9 * shape[-1])).astype(np.float32)
    dy = rng.standard_normal((*shape[:3], co)).astype(np.float32)
    return x, w, dy


def _close(got, want, name):
    want = np.asarray(want)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert got.shape == want.shape and err <= TOL, f"{name}: rel err {err:.3e}"


@pytest.mark.parametrize("shape,co", SHAPES)
def test_forward_and_gradients_match_jax_kernel(shape, co):
    x, w, dy = _inputs(shape, co)
    with pltpu.force_tpu_interpret_mode():
        want, vjp = jax.vjp(conv3x3_tpu, jnp.asarray(x), jnp.asarray(w))
        want_dx, want_dw = vjp(jnp.asarray(dy))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = conv3x3(xt, wt)
    got.backward(torch.from_numpy(dy))
    _close(got.detach().numpy(), want, "y")
    _close(xt.grad.numpy(), want_dx, "dx")
    _close(wt.grad.numpy(), want_dw, "dw")


def test_backward_is_the_plain_convs():
    x, w, dy = (torch.from_numpy(a) for a in _inputs((2, 5, 7, 16), 24, seed=1))
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    conv3x3_reference(xl, wl).backward(dy)
    dx, dw = conv3x3_backward(x, w, dy)
    torch.testing.assert_close(dx, xl.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, wl.grad, atol=1e-5, rtol=1e-5)


def test_repacked_weight_puts_channels_last():
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    packed = repack_weight(w, torch.bfloat16)
    assert packed.shape == (2, 3, 3, 3) and packed.is_contiguous()
    assert packed.dtype == torch.bfloat16
    assert torch.equal(packed.float()[1, 2, 0], w[1, :, 2, 0])


# SDXL's UNet 3x3 convs at 1024 px (``tests/ops/test_conv3x3.py:28-33``), its
# up-block concat, and the VAE decoder's at 1024 px: (H = W, C, CO)
SDXL_AND_VAE = [(128, 320, 320), (64, 640, 640), (32, 1280, 1280), (32, 2560, 1280),
                (128, 512, 512), (256, 512, 512), (512, 256, 256), (1024, 128, 128)]


@pytest.mark.parametrize("hw,c,co", SDXL_AND_VAE)
def test_gate_takes_every_sdxl_and_vae_shape(hw, c, co):
    assert conv3x3_supported((2 if c != 128 else 1, hw, hw, c), co)
    if (hw, c, co) != (32, 2560, 1280):  # the JAX gate's one refusal: see below
        assert jax_supported((1, hw, hw, c), co)


@pytest.mark.parametrize("x_shape,co,kernel,jax_gate", [
    ((1, 8, 8, 3), 16, False, True),  # C = 3: not a 16-wide contraction step
    ((1, 8, 8, 16), 20, False, True),  # CO % 8 != 0
    ((1, 8, 8, 65536), 65536, True, False),  # past the TPU's VMEM budget, not past the kernel
    ((2, 32, 32, 2560), 1280, True, False),  # SDXL's up-block concat: 11.8 MB of weight blocks
    ((1, 1, 1, 16), 8, True, True),  # one pixel
    ((1, 0, 8, 16), 8, False, False),  # no pixel
])
def test_gate_differs_from_the_jax_gate_where_its_docstring_says(x_shape, co, kernel, jax_gate):
    assert conv3x3_supported(x_shape, co) is kernel
    assert jax_supported(x_shape, co) is jax_gate


def test_plain_version_is_the_wrapper_on_the_cpu():
    x, w, _ = (torch.from_numpy(a) for a in _inputs((1, 6, 6, 16), 8, seed=2))
    before = conv3x3.launches
    assert torch.equal(conv3x3(x, w), conv3x3_reference(x, w))
    assert conv3x3.launches == before


@pytest.mark.parametrize("module,export", [("conv3x3", "conv3x3_nhwc"),
                                           ("group_norm", "fused_group_norm")])
def test_ops_package_exports_the_wrappers_and_keeps_the_modules(module, export):
    import importlib
    import types

    import vision_ft_tpu_torch.ops as ops

    mod = importlib.import_module(f"vision_ft_tpu_torch.ops.{module}")
    assert isinstance(getattr(ops, module), types.ModuleType) and getattr(ops, module) is mod
    assert getattr(ops, export) is getattr(mod, module)
    assert export in ops.__all__


@pytest.mark.parametrize("height,width,box_w", [
    (128, 128, 128), (64, 64, 64), (32, 32, 32),  # SDXL's square stages: whole rows
    (1024, 1024, 128), (9, 9, 16),
    (104, 152, 32), (52, 76, 16), (26, 38, 8),  # the 832x1216 bucket's latents
    (1, 1, 128), (130, 3, 8),
])
def test_pixel_box_covers_the_image_in_the_fewest_tiles(height, width, box_w):
    assert pixel_box(height, width) == box_w

    def tiles(bw):
        return -(-width // bw) * -(-height // (128 // bw))
    assert all(tiles(box_w) <= tiles(bw) for bw in (128, 64, 32, 16, 8))


@pytest.mark.parametrize("tiles,steps,splits", [
    (80, 360, 3),  # SDXL's up-block concat (2, 32, 32, 2560) -> 1280: 0.6 waves unsplit
    (80, 180, 3),  # (2, 32, 32, 1280) -> 1280
    (160, 360, 4), (160, 180, 3),  # the same at 128-channel tiles: 1.2 waves unsplit
    (320, 90, 1),  # (2, 64, 64, 640) -> 640
    (768, 45, 1), (8192, 18, 1),  # the first stage, the VAE's last
    (200, 180, 1),  # three parts would tie
    (1, 9, 1), (2, 9, 1),  # a tile or two: the partials' cost outweighs the waves
    (1, 360, MAX_SPLITS),
])
def test_conv_splits_cuts_k_only_where_the_tiles_fill_the_card_badly(tiles, steps, splits):
    assert conv_splits(tiles, steps, 132) == splits
    assert 1 <= conv_splits(tiles, 2, 132) <= 2


@pytest.mark.parametrize("x_shape,co,plan", [
    ((2, 64, 64, 640), 640, (64, 160, 1)),  # 256 tiles of 160 channels: 2 waves, 320 of 128: 3
    ((2, 128, 128, 320), 320, (128, 160, 1)),
    ((2, 32, 32, 1280), 1280, (32, 160, 1)),  # 128 tiles of 160 fill the card unsplit
    ((2, 32, 32, 2560), 1280, (32, 160, 1)),
    ((2, 32, 32, 640), 640, (32, 160, 2)),  # 64 tiles: K in two parts
    ((1, 1024, 1024, 128), 128, (128, 128, 1)),
    ((1, 256, 256, 512), 512, (128, 256, 1)),
    ((2, 26, 38, 1280), 1280, (8, 256, 1)),  # the 832x1216 bucket's third stage
    ((2, 52, 76, 640), 640, (16, 128, 1)),  # 350 tiles of 128 fill 3 waves better than 280 of 160
    ((2, 104, 152, 320), 320, (32, 160, 1)),
    ((2, 96, 96, 48), 96, (32, 128, 1)),  # CO divides by no wider tile
    ((1, 9, 9, 16), 32, (16, 128, 1)),
])
def test_conv_plan_picks_the_box_the_channel_tile_and_the_parts(x_shape, co, plan):
    assert conv_plan(x_shape, co, 132) == plan
    box_w, tile_n, splits = plan
    b, h, w, c = x_shape
    tiles = b * -(-w // box_w) * -(-h // (128 // box_w)) * -(-co // tile_n)
    assert box_w == pixel_box(h, w) and (tile_n == 128 or co % tile_n == 0)
    assert splits == conv_splits(tiles, 9 * -(-c // 64), 132)
