"""Image transforms (PIL/numpy, NHWC float in [-1, 1]).

``vision_ft_tpu/dataset/transform.py`` counterpart, the transforms the
text-to-image dataset uses: ObjectCoverResize (cover-fit keeping AR,
ceil-scaled, bicubic) and the conversion to HWC float32 numpy arrays;
batching stacks to NHWC (the port's layout).
"""

from __future__ import annotations

import math
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
