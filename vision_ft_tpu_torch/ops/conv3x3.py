"""3x3, stride-1, pad-1 NHWC convolution: wrapper, gate, plain version and backward.

Counterpart of ``vision_ft_tpu/ops/pallas/conv3x3.py::conv3x3_tpu``, its
custom VJP and its gate ``conv3x3_supported``. As there, the op is
available and no model path calls it: ``nn.core.Conv2d`` keeps its own
route. The forward kernel is CUDA C++, ``csrc/conv3x3.cu`` (an implicit
GEMM on TMA and wgmma), built for ``sm_90a`` by ``ops/_build.py`` and
bound with ``ctypes``; the backward is, as in the JAX package, the plain
conv's.

- :func:`conv3x3_reference` is the plain PyTorch version: ``F.conv2d`` on
  NCHW views, no bias, the output in x's dtype.
- :func:`conv3x3_backward` gives (dx, dw) through the plain conv, as the
  JAX ``_bwd`` does through ``_xla_conv``.
- :func:`conv3x3_supported` states what the kernel takes;
  :func:`conv_plan` is the launch's shape (pixel box, channel tile, parts
  of K), from :func:`pixel_box` and :func:`conv_splits`: pure functions of
  the shape and the card's SM count.
- :func:`conv3x3` is the wrapper. For a CPU tensor its forward is the
  plain version. For a CUDA tensor it launches the kernel or raises
  ``ValueError`` (not bf16, not contiguous, a shape the gate rejects); it
  counts its launches in ``conv3x3.launches``. When gradients are wanted
  it goes through a ``torch.autograd.Function`` whose backward is
  :func:`conv3x3_backward`.

Layout: x (B, H, W, C), w (CO, C, 3, 3), y (B, H, W, CO). The wrapper
repacks w to (CO, 3, 3, C) in x's dtype (:func:`repack_weight`), so that
the kernel's contraction axis (tap, channel) is contiguous.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

_TILE = 128  # output pixels a block of the kernel owns, and its narrowest channel tile
_MAX_GRID_Y = 65535
BOX_WIDTHS = (128, 64, 32, 16, 8)  # pixel boxes of a tile: box_w x (128 // box_w)
# output channels a block, and the rate of a K step of a tile per output
# channel against the 128-wide tile's (measured on an H100: a wider tile
# reads its A tile once for more products)
TILE_RATES = {256: 1.2, 160: 1.17, 128: 1.0}
STEP_C = 64  # channels a K step of one tap
MAX_SPLITS = 8
# conv_splits' cost model, in units of one K step of one block: each part's
# fp32 partial of a tile is written and read back (about a tenth of a
# step's time on the card), and the sum is one more launch
SPLIT_TILE_COST, SPLIT_LAUNCH_COST = 0.1, 10.0


def conv3x3_supported(x_shape, co: int) -> bool:
    """What kernel K takes: x (B, H, W, C) with C % 16 == 0 (32-byte pixel
    rows for its tensor maps; channels past C are read as TMA's zeros),
    CO % 8 == 0, at least one pixel, and at most 65535 * 128 output pixels
    (the first design's grid, a limit kept so that the gate is unchanged).

    The JAX gate (``_pick_blocks``) asks instead whether a block of rows
    and the weights fit the TPU's VMEM: it takes channel counts this
    kernel refuses (C = 3, CO = 20) and refuses shapes this kernel takes:
    weight blocks past its VMEM budget, among them SDXL's up-block concat
    (32, 32, 2560) -> 1280 and C = CO = 65536. This gate is True on every
    SDXL UNet and VAE 3x3 conv."""
    if len(x_shape) != 4:
        return False
    b, h, w, c = x_shape
    pixels = b * h * w
    return (c > 0 and c % 16 == 0 and co > 0 and co % 8 == 0
            and 0 < pixels <= _MAX_GRID_Y * _TILE)


def pixel_box(height: int, width: int) -> int:
    """The width of a tile's pixel box (its height is 128 // width): the
    box of ``BOX_WIDTHS`` whose tiles cover an H x W image in the fewest,
    the wider on a tie. SDXL's square stages take whole rows (128 x 1 at
    W = 128); the 832 x 1216 bucket's 104 x 152 latents 32 x 4 boxes."""
    def tiles(box_w):
        return -(-width // box_w) * -(-height // (_TILE // box_w))
    return min(BOX_WIDTHS, key=lambda box_w: (tiles(box_w), -box_w))


def _cost(tiles: int, steps: int, splits: int, sms: int) -> float:
    """Waves of blocks times K steps a part, plus the partials' round trip
    and the sum's launch when K is cut: in K steps of one block."""
    waves = -(-tiles * splits // sms) * -(-steps // splits)
    if splits == 1:
        return waves
    return waves + SPLIT_LAUNCH_COST + SPLIT_TILE_COST * splits * tiles


def conv_splits(tiles: int, steps: int, sms: int) -> int:
    """Parts the kernel cuts its ``steps`` K steps (9 taps x ceil(C / 64))
    into when its ``tiles`` (pixel box, channel tile) blocks fill ``sms``
    SMs badly: the count, at most ``MAX_SPLITS`` and no more than there are
    steps, of least cost (:func:`_cost`); 1 on a tie."""
    return min(range(1, min(MAX_SPLITS, steps) + 1),
               key=lambda splits: (_cost(tiles, steps, splits, sms), splits))


@functools.lru_cache(maxsize=256)
def conv_plan(x_shape, co: int, sms: int) -> tuple[int, int, int]:
    """(box_w, tile_n, splits) of kernel K's launch for x (B, H, W, C) ->
    CO on ``sms`` SMs: the pixel box's width (:func:`pixel_box`), the output
    channels a block (128, or a width of ``TILE_RATES`` that divides CO)
    and the parts of K (:func:`conv_splits`), the tile width of least cost
    per unit of its rate (the narrower on a tie)."""
    b, h, w, c = x_shape
    box_w = pixel_box(h, w)
    steps = 9 * -(-c // STEP_C)
    plans = []
    for tile_n, rate in TILE_RATES.items():
        if co % tile_n and tile_n != _TILE:
            continue
        tiles = b * -(-w // box_w) * -(-h // (_TILE // box_w)) * -(-co // tile_n)
        splits = conv_splits(tiles, steps, sms)
        plans.append((_cost(tiles, steps, splits, sms) * tile_n / rate, tile_n, splits))
    _, tile_n, splits = min(plans)
    return box_w, tile_n, splits


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx, dw) of :func:`conv3x3_reference`: the plain conv's backward
    (no forward recomputed); dx in x's dtype, dw in w's."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2).to(x.dtype), x.permute(0, 3, 1, 2), w.to(x.dtype),
        None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False],
    )
    return dx.permute(0, 2, 3, 1).contiguous(), dw.to(w.dtype)


def repack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(CO, C, 3, 3) -> contiguous (CO, 3, 3, C) in ``dtype``."""
    return w.to(dtype).permute(0, 2, 3, 1).contiguous()


@functools.cache
def _kernel():
    fn = _build.cuda_library("conv3x3").conv3x3_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 4 or w.shape[1:] != (x.shape[3], 3, 3):
        raise ValueError(f"conv3x3 takes x (B, H, W, C) and w (CO, C, 3, 3), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"conv3x3 kernel takes a contiguous bf16 x, got {x.dtype} "
                         f"contiguous={x.is_contiguous()}")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3 kernel takes a 16-byte aligned x")
    if w.device != x.device:
        raise ValueError(f"w must be on {x.device}, got {w.device}")
    if not conv3x3_supported(tuple(x.shape), w.shape[0]):
        raise ValueError(f"conv3x3 kernel takes C % 16 == 0, CO % 8 == 0 and 1 to "
                         f"{_MAX_GRID_Y * _TILE} pixels; got x {tuple(x.shape)}, CO {w.shape[0]}")


def conv3x3_forward(x: torch.Tensor, w_packed: torch.Tensor) -> torch.Tensor:
    """y (B, H, W, CO) from x (B, H, W, C) bf16 and the repacked weight
    (CO, 3, 3, C) bf16: the kernel, on the card only."""
    b, h, width, c = x.shape
    co = w_packed.shape[0]
    if w_packed.shape != (co, 3, 3, c) or w_packed.dtype != x.dtype or not w_packed.is_contiguous():
        raise ValueError(f"conv3x3 kernel takes a contiguous (CO, 3, 3, {c}) {x.dtype} weight, "
                         f"got {w_packed.dtype} {tuple(w_packed.shape)}")
    y = torch.empty((b, h, width, co), device=x.device, dtype=x.dtype)
    box_w, tile_n, splits = conv_plan(
        tuple(x.shape), co, _build.sm_count(x.device))
    partial = (torch.empty((splits, b, h, width, co), device=x.device, dtype=torch.float32)
               if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w_packed.data_ptr(), y.data_ptr(),
                        None if partial is None else partial.data_ptr(), b, h, width, c, co,
                        box_w, tile_n, splits, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 launch failed: CUDA error {err}")
    conv3x3.launches += 1
    return y


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return conv3x3_reference(x, w)
    _check(x, w)
    return conv3x3_forward(x, repack_weight(w, x.dtype))


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return conv3x3_backward(x, w, dy)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = conv3x3(x, w): x (B, H, W, C) (bf16 on the card), w (CO, C, 3, 3),
    stride 1, pad 1, no bias. Differentiable in x and w."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w)
    return _forward(x, w)


conv3x3.launches = 0
