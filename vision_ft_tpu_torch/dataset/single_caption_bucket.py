"""Single-caption dataset (``vision_ft_tpu/dataset/single_caption_bucket.py``
counterpart): each ``.txt`` under a folder is one caption item; a size
is drawn for each from a gaussian over the bucket step grid (Python's
global ``random``, as in the JAX package) and the items are classified
into aspect-ratio buckets. No images: a workload generates from the
captions alone.
"""

from __future__ import annotations

import os
import random
import warnings
from collections import defaultdict
from functools import reduce
from pathlib import Path
from typing import Optional

from pydantic import BaseModel

from .aspect_ratio_bucket import (
    AspectRatioBucket,
    AspectRatioBucketConfig,
    AspectRatioBucketManager,
    print_arb_info,
)
from .bucket import BucketDataset
from .caption import CaptionProcessorList
from .util import ConcatDataset


class SingleCaption(BaseModel):
    caption: Path
    height: Optional[int] = None
    width: Optional[int] = None

    def read_caption(self) -> str:
        return self.caption.read_text().strip()


class SingleCaptionBucket(AspectRatioBucket):
    def __init__(
        self,
        items: list[SingleCaption],
        batch_size: int,
        width: int,
        height: int,
        num_repeats: int,
        caption_processors: CaptionProcessorList | None = None,
    ):
        super().__init__(items=items, batch_size=batch_size, num_repeats=num_repeats)
        self.width = int(width)
        self.height = int(height)
        self.caption_processors = caption_processors or []

    def __getitem__(self, idx: int | slice):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        items: list[SingleCaption] = super().__getitem__(idx)
        captions = [
            reduce(lambda c, p: p(c), self.caption_processors, item.read_caption())
            for item in items
        ]
        return {
            "caption": captions,
            "height": [item.height for item in items],
            "width": [item.width for item in items],
        }


class SingleCaptionDatasetConfig(AspectRatioBucketConfig):
    caption_extension: str = ".txt"
    folder: str
    num_repeats: int = 1
    caption_processors: CaptionProcessorList = []

    def _retrive_images(self) -> list[SingleCaption]:
        captions = []
        for root, _, files in os.walk(self.folder):
            for file_name in files:
                file = Path(file_name)
                if file.suffix == self.caption_extension:
                    captions.append(SingleCaption(caption=Path(root) / file))
        return captions

    def generate_buckets(self) -> list[SingleCaptionBucket]:
        arb_manager = AspectRatioBucketManager(self.buckets)
        bucket_subsets: dict[int, list[SingleCaption]] = defaultdict(list)
        num_steps = (self.bucket_base_size - self.min_size) // self.step * 2
        for item in self._retrive_images():
            # gaussian size sampling on the step grid
            width = int(random.normalvariate(num_steps / 2, 0.5)) * self.step + self.min_size
            height = int(random.normalvariate(num_steps / 2, 0.5)) * self.step + self.min_size
            try:
                bucket_idx = arb_manager.find_nearest(width, height)
            except AssertionError:
                warnings.warn(
                    f"Sampled size {width}x{height} matches no bucket. Skipping...",
                    UserWarning,
                )
                continue
            item.width = width
            item.height = height
            bucket_subsets[bucket_idx].append(item)

        buckets = []
        for bucket_idx, items in bucket_subsets.items():
            if not items:
                continue
            width, height = self.buckets[bucket_idx]
            buckets.append(
                SingleCaptionBucket(
                    items=items,
                    batch_size=self.batch_size,
                    width=width,
                    height=height,
                    num_repeats=self.num_repeats,
                    caption_processors=self.caption_processors,
                )
            )
        return buckets

    def get_dataset(self) -> ConcatDataset:
        buckets = self.generate_buckets()
        print_arb_info(buckets)
        return ConcatDataset([BucketDataset(bucket) for bucket in buckets])
