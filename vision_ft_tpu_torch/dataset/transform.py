"""Image transforms (PIL/numpy, NHWC float in [-1, 1]).

``vision_ft_tpu/dataset/transform.py`` counterpart, the transforms the
text-to-image dataset uses: ObjectCoverResize (cover-fit keeping AR,
ceil-scaled, bicubic) and the conversion to HWC float32 numpy arrays;
batching stacks to NHWC (the port's layout). The IP-Adapter's reference
images take PaddedResize (fit inside a square, pad) and ColorChannelSwap.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from PIL import Image


def to_array(img: Image.Image) -> np.ndarray:
    """PIL -> HWC float32 in [-1, 1] (x / 255 * 2 - 1)."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


class ObjectCoverResize:
    """Resize so the image *covers* (width, height), keeping AR
    (scale = max(w_scale, h_scale), ceil)."""

    def __init__(self, width: int, height: int, do_upscale: bool = False,
                 resample=Image.BICUBIC):
        self.target_width = width
        self.target_height = height
        self.do_upscale = do_upscale
        self.resample = resample

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        if (w < self.target_width or h < self.target_height) and not self.do_upscale:
            raise ValueError(
                f"Image is too small to crop to {self.target_width}x{self.target_height}"
            )
        scale = max(self.target_width / w, self.target_height / h)
        scaled_w = math.ceil(w * scale)
        scaled_h = math.ceil(h * scale)
        return img.resize((scaled_w, scaled_h), resample=self.resample)


class PaddedResize:
    """Fit inside a ``max_size`` square (bilinear), centred on a
    ``fill``-coloured canvas of exactly (max_size, max_size)."""

    def __init__(self, max_size: int, fill: int | Sequence[int] = 0,
                 resample=Image.BILINEAR):
        self.max_size = max_size
        self.fill = fill
        self.resample = resample

    def __call__(self, img: Image.Image) -> Image.Image:
        w, h = img.size
        scale = self.max_size / max(w, h)
        new_w = max(round(w * scale), 1)
        new_h = max(round(h * scale), 1)
        img = img.resize((new_w, new_h), resample=self.resample)
        fill = tuple(self.fill) if isinstance(self.fill, (list, tuple)) else (self.fill,) * 3
        canvas = Image.new("RGB", (self.max_size, self.max_size), fill)
        canvas.paste(img, ((self.max_size - new_w) // 2, (self.max_size - new_h) // 2))
        return canvas


class ColorChannelSwap:
    """Reorder the channels of an HWC / NHWC array."""

    def __init__(self, swap: Sequence[int] = (0, 1, 2), skip: bool = False):
        self.swap = tuple(swap)
        self.skip = skip

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if self.skip:
            return img
        if img.ndim in (3, 4) and img.shape[-1] == 3:
            return img[..., list(self.swap)]
        raise ValueError("Input image must be HWC or NHWC with 3 channels")
