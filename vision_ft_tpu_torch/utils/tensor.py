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


def tensor_to_images(tensor: torch.Tensor) -> list[Image.Image]:
    """NHWC float in [-1, 1] -> PIL images."""
    arr = tensor.clamp(-1.0, 1.0).float().cpu().numpy()
    arr = np.nan_to_num(arr)  # NaN-safe (random-init weights)
    arr = ((arr + 1.0) / 2.0 * 255.0).astype(np.uint8)
    return [Image.fromarray(im) for im in arr]
