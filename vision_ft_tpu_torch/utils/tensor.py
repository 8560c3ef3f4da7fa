"""Noise and image helpers (``vision_ft_tpu/utils/tensor.py`` counterpart).

``incremental_seed_randn`` keeps the per-sample-seed semantics (sample i
is drawn from seed + i, so a batch is order-independent) with one
``torch.Generator`` per sample. PyTorch and JAX give different numbers
from one seed; tests that compare the two packages hand both the same
noise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image


def incremental_seed_randn(
    shape: tuple[int, ...],
    seed: Optional[int],
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Standard-normal noise where batch element i is drawn from a
    generator seeded ``(seed & 0x7FFFFFFF) + i``; ``seed=None`` draws a
    random seed."""
    if len(shape) == 0:
        raise ValueError("Shape must have at least one dimension")
    if seed is None:
        seed = int(np.random.randint(0, 2**31 - 1))
    seed = int(seed) & 0x7FFFFFFF
    device = torch.device("cpu") if device is None else torch.device(device)
    samples = []
    for i in range(shape[0]):
        generator = torch.Generator(device=device).manual_seed(seed + i)
        samples.append(torch.randn(shape[1:], generator=generator, device=device))
    return torch.stack(samples).to(dtype)


def image_to_tensor(image: Image.Image, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PIL image -> HWC float in [-1, 1]."""
    arr = np.asarray(image.convert("RGB"), dtype=np.float32) / 127.5 - 1.0
    return torch.from_numpy(arr).to(dtype)


def images_to_tensor(images: list[Image.Image], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """PIL images of one size -> NHWC float in [-1, 1]."""
    return torch.stack([image_to_tensor(im, dtype) for im in images])


def tensor_to_images(tensor: torch.Tensor) -> list[Image.Image]:
    """NHWC float in [-1, 1] -> PIL images."""
    arr = tensor.clamp(-1.0, 1.0).float().cpu().numpy()
    arr = np.nan_to_num(arr)  # NaN-safe (random-init weights)
    arr = ((arr + 1.0) / 2.0 * 255.0).astype(np.uint8)
    return [Image.fromarray(im) for im in arr]


def videos_to_tensor(videos: list[list[Image.Image]], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Lists of frames -> (B, F, H, W, C) float in [-1, 1]."""
    return torch.stack([images_to_tensor(frames, dtype) for frames in videos])


def tensor_to_videos(tensor: torch.Tensor) -> list[list[Image.Image]]:
    """(B, F, H, W, C) float in [-1, 1] -> one list of frames a sample."""
    return [tensor_to_images(video) for video in tensor]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _cubic_weights(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(in_size, out_size) fp32 weights of one axis, as ``jax.image.resize``
    computes them: half-pixel sample centres, the kernel widened by the
    downscale factor when ``antialias``, each column normalized, samples
    outside the input zero."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = _keys_cubic(x).astype(f32)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1), 0,
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(f32)


def resize_cubic(images: torch.Tensor, height: int, width: int, antialias: bool = True) -> torch.Tensor:
    """Bicubic resize of NHWC images to (height, width) in fp32 (the
    ``jax.image.resize(..., method="cubic")`` arithmetic: Keys' kernel,
    antialiased when downscaling); differentiable in the images."""
    _, h, w, _ = images.shape
    x = images.float()
    wh = torch.from_numpy(_cubic_weights(h, height, antialias)).to(x.device)
    ww = torch.from_numpy(_cubic_weights(w, width, antialias)).to(x.device)
    return torch.einsum("bhwc,hH,wW->bHWc", x, wh, ww)
