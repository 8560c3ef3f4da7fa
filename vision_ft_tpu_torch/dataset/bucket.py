"""Bucket primitives.

``vision_ft_tpu/dataset/bucket.py`` counterpart: a Bucket
wraps items with modular (repeat-aware) indexing; a BucketDataset exposes
ceil(len/batch) indices, each returning a FULL batch slice (so the outer
loader runs batch_size=1 and every batch stays within one resolution
bucket, one shape per bucket).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


class Bucket:
    def __init__(self, items: Sequence, batch_size: int, num_repeats: int = 1):
        self.items = items
        self.num_items = len(items)
        self.batch_size = batch_size
        self.num_repeats = num_repeats

    def __len__(self) -> int:
        return len(self.items) * self.num_repeats

    def to_local_idx(self, idx: int | slice) -> int | list[int]:
        if isinstance(idx, int):
            return idx % self.num_items
        start, stop, step = idx.indices(10**10)
        return (np.arange(start, stop, step) % self.num_items).tolist()

    def __getitem__(self, idx: int | slice):
        local_idx = self.to_local_idx(idx)
        if isinstance(local_idx, list):
            return [self.items[i] for i in local_idx]
        return self.items[local_idx]


class BucketDataset:
    """len = ceil(len(bucket)/batch); __getitem__ returns a whole batch."""

    def __init__(self, bucket: Bucket):
        self.bucket = bucket
        self.num_samples = math.ceil(len(bucket) / bucket.batch_size)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int):
        # as in the JAX package: the start offset
        # wraps on num_items, not num_samples
        real_idx = idx % self.bucket.num_items
        start = real_idx * self.bucket.batch_size
        return self.bucket[start : start + self.bucket.batch_size]
