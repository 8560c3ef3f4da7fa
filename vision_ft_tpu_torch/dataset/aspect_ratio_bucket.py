"""NovelAI-style aspect-ratio bucketing.

``vision_ft_tpu/dataset/aspect_ratio_bucket.py`` counterpart, the same
rules: bucket enumeration (walk widths down by `step`, pair with heights from
target_area, emit both orientations), nearest-bucket selection (largest
resolution whose box fits inside the image, closest aspect ratio), info
printing. Pure numpy.

Each bucket is one (W, H): every batch of a bucket has one shape, and the
bucket set is bounded by construction (~25 shapes at base 1024/step
64/min 384).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .bucket import Bucket
from .util import DatasetConfig


class AspectRatioBucket(Bucket):
    width: int
    height: int


def generate_buckets(
    target_area: int = 1024 * 1024,
    start_size: int = 1024,
    step: int = 64,
    min_size: int = 64,
) -> np.ndarray:
    """Enumerate (w, h) pairs with w*h ≈ target_area, both divisible by
    ``step``, emitting every
    height from the rounded ideal down to min_size for each width)."""
    buckets: list[np.ndarray] = []
    w = start_size
    while w >= min_size:
        h_rounded = round((target_area / w) / step) * step
        if h_rounded < min_size:
            break
        for h in range(h_rounded, min_size, -step):
            buckets.append(np.array([w, h]))
            if w != h_rounded:
                buckets.append(np.array([h, w]))
        w -= step
    return np.stack(buckets)


class AspectRatioBucketConfig(DatasetConfig):
    bucket_base_size: int = 1024
    step: int = 64
    min_size: int = 384

    @property
    def buckets(self) -> np.ndarray:
        return generate_buckets(
            target_area=self.bucket_base_size**2,
            start_size=self.bucket_base_size,
            step=self.step,
            min_size=self.min_size,
        )

    def generate_buckets(self) -> list[AspectRatioBucket]:
        raise NotImplementedError

    def get_dataset(self):
        raise NotImplementedError


class AspectRatioBucketManager:
    def __init__(self, buckets: np.ndarray):
        self.buckets = buckets
        self.aspect_ratios = buckets[:, 0] / buckets[:, 1]
        self.resolutions = buckets[:, 0] * buckets[:, 1]

    def __len__(self) -> int:
        return self.buckets.shape[0]

    def __iter__(self):
        for bucket in self.buckets:
            yield bucket[0], bucket[1]

    @staticmethod
    def aspect_ratio(width: int, height: int) -> float:
        return width / height

    def find_nearest(self, width: int, height: int) -> int:
        """Largest-resolution bucket that fits inside the image with the
        closest aspect ratio. Raises AssertionError if
        no bucket fits (image smaller than every bucket)."""
        provided_ar = self.aspect_ratio(width, height)
        min_diff = float("inf")
        best_idx = None
        for idx in np.argsort(-self.resolutions):
            bw, bh = self.buckets[idx]
            if bw > width or bh > height:
                continue
            diff = abs(provided_ar - self.aspect_ratios[idx])
            if diff > min_diff and best_idx is not None:
                break
            min_diff = diff
            best_idx = idx
        assert best_idx is not None
        return int(best_idx)


def print_arb_info(bucket_ds: Sequence[AspectRatioBucket], print_fn=print) -> None:
    print_fn("===== Bucket info =====")
    print_fn(f"=== Number of buckets: {len(bucket_ds)}")
    for idx, bucket in enumerate(bucket_ds):
        print_fn(
            f"Bucket {idx:>3} | {bucket.width:>6,}x{bucket.height:<6,} | "
            f"{bucket.num_items:>8,} images |"
        )
    print_fn("===== End of Bucket info =====")
