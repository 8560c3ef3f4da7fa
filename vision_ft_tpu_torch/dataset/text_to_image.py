"""Text-to-image folder dataset with aspect-ratio bucketing.

``vision_ft_tpu/dataset/text_to_image.py`` counterpart: walk a
folder for images with ``.txt`` captions or ``.json`` metadata (danbooru /
wd-tagger tag dicts, ``skip`` flag, caption/captions keys), classify each
pair into its nearest AR bucket, and serve *whole batches*: cover-resize
to the bucket box, random-crop, return image + SDXL micro-conditioning
(original_size, target_size, crop_coords_top_left) + processed caption.

Images land as NHWC float32 numpy in [-1, 1]; pairs are read lazily per
batch (the frozen encoders' outputs are cached by the training model).
Crops draw from the bucket's numpy generator, randomized caption
processors from the global ``random`` module, as in the JAX package, so
both give the same batches for the same seeds.
"""

from __future__ import annotations

import json
import os
import random
import warnings
from collections import defaultdict
from functools import reduce
from pathlib import Path
from typing import Optional

import numpy as np
from PIL import Image
from pydantic import BaseModel

from .aspect_ratio_bucket import (
    AspectRatioBucket,
    AspectRatioBucketConfig,
    AspectRatioBucketManager,
    print_arb_info,
)
from .bucket import BucketDataset
from .caption import CaptionProcessorList
from .tags import format_general_character_tags, map_replace_underscore
from .transform import ObjectCoverResize, to_array
from .util import ConcatDataset


def get_image_size(path: Path) -> tuple[int, int]:
    """(width, height) from the header only (imagesize-module analogue)."""
    with Image.open(path) as img:
        return img.size


class ImageCaptionPair(BaseModel):
    image: Path
    width: int
    height: int
    caption: Optional[Path] = None
    metadata: Optional[Path] = None

    def read_caption(self) -> str:
        if self.metadata is not None:
            with open(self.metadata) as f:
                metadata = json.load(f)
            if "tag_string" in metadata:
                return format_general_character_tags(
                    general=map_replace_underscore(
                        metadata.get("tag_string_general", "").split(" ")
                    ),
                    character=map_replace_underscore(
                        metadata.get("tag_string_copyright", "").split(" ")
                        + metadata.get("tag_string_character", "").split(" ")
                    ),
                    rating=metadata.get("rating", "general"),
                )
            if "tagger" in metadata:  # wd-tagger-rs format
                return format_general_character_tags(
                    general=metadata["tagger"].get("general", []),
                    character=metadata["tagger"].get("character", []),
                    rating=metadata.get("rating", "general"),
                )
            if "tags" in metadata:
                return metadata["tags"]
            if "caption" in metadata:
                return metadata["caption"]
            if "captions" in metadata:
                return random.choice(metadata["captions"])
            raise ValueError(
                f"Caption not found in metadata {self.metadata}. "
                f"Available keys: {', '.join(metadata.keys())}"
            )
        assert self.caption is not None
        return self.caption.read_text()

    @property
    def should_skip(self) -> bool:
        if self.metadata is None:
            return False
        with open(self.metadata) as f:
            metadata = json.load(f)
        return bool(metadata.get("skip", False))


class TextToImageBucket(AspectRatioBucket):
    """Serves whole batches of transformed images + captions."""

    def __init__(
        self,
        items: list[ImageCaptionPair],
        batch_size: int,
        width: int,
        height: int,
        do_upscale: bool,
        num_repeats: int,
        caption_processors: CaptionProcessorList | None = None,
        rng: Optional[np.random.Generator] = None,
    ):
        super().__init__(items=items, batch_size=batch_size, num_repeats=num_repeats)
        self.width = int(width)
        self.height = int(height)
        self.do_upscale = do_upscale
        self.caption_processors = caption_processors or []
        self.resize = ObjectCoverResize(self.width, self.height, do_upscale=do_upscale)
        self.rng = rng or np.random.default_rng()

    def _random_crop(self, arr: np.ndarray) -> tuple[np.ndarray, int, int]:
        h, w = arr.shape[:2]
        top = int(self.rng.integers(0, h - self.height + 1))
        left = int(self.rng.integers(0, w - self.width + 1))
        return arr[top : top + self.height, left : left + self.width], top, left

    def __getitem__(self, idx: int | slice):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        pairs: list[ImageCaptionPair] = super().__getitem__(idx)

        images, original_size, target_size, crops, captions = [], [], [], [], []
        for pair in pairs:
            with Image.open(pair.image) as img:
                resized = self.resize(img)
                arr = to_array(resized)
            cropped, top, left = self._random_crop(arr)
            images.append(cropped)
            original_size.append([arr.shape[0], arr.shape[1]])
            target_size.append([self.height, self.width])
            crops.append([top, left])
            caption = reduce(
                lambda c, processor: processor(c), self.caption_processors,
                pair.read_caption(),
            )
            captions.append(caption)

        return {
            "image": np.stack(images),  # (B, H, W, C) in [-1, 1]
            "original_size": np.asarray(original_size, np.float32),
            "target_size": np.asarray(target_size, np.float32),
            "crop_coords_top_left": np.asarray(crops, np.float32),
            "caption": captions,
            "width": [self.width] * len(pairs),
            "height": [self.height] * len(pairs),
        }


class TextToImageDatasetConfig(AspectRatioBucketConfig):
    supported_extensions: list[str] = [".png", ".jpg", ".jpeg", ".webp", ".avif"]
    caption_extension: str = ".txt"
    metadata_extension: str = ".json"

    folder: str

    do_upscale: bool = False
    num_repeats: int = 1

    caption_processors: CaptionProcessorList = []

    def _retrive_images(self) -> list[ImageCaptionPair]:
        # (the method name's spelling is the JAX package's)
        pairs: list[ImageCaptionPair] = []
        for root, _, files in os.walk(self.folder):
            for file_name in files:
                file = Path(file_name)
                if file.suffix not in self.supported_extensions:
                    continue
                image_path = Path(root) / file
                caption_path = Path(root) / (file.stem + self.caption_extension)
                if not caption_path.exists():
                    caption_path = None
                metadata_path = Path(root) / (file.stem + self.metadata_extension)
                if not metadata_path.exists():
                    metadata_path = None
                if caption_path is None and metadata_path is None:
                    raise FileNotFoundError(
                        f"Caption or metadata file not found for image {image_path}"
                    )
                width, height = get_image_size(image_path)
                pair = ImageCaptionPair(
                    image=image_path,
                    width=width,
                    height=height,
                    caption=caption_path,
                    metadata=metadata_path,
                )
                if not pair.should_skip:
                    pairs.append(pair)
        return pairs

    def generate_buckets(self) -> list[TextToImageBucket]:
        arb_manager = AspectRatioBucketManager(self.buckets)
        bucket_subsets: dict[int, list[ImageCaptionPair]] = defaultdict(list)
        for pair in self._retrive_images():
            try:
                bucket_idx = arb_manager.find_nearest(pair.width, pair.height)
                bucket_subsets[bucket_idx].append(pair)
            except AssertionError:
                warnings.warn(
                    f"Image size {pair.width}x{pair.height} is too small and "
                    "do_upscale is False. Skipping...",
                    UserWarning,
                )
        buckets = []
        for bucket_idx, pairs in bucket_subsets.items():
            if not pairs:
                continue
            width, height = self.buckets[bucket_idx]
            buckets.append(
                TextToImageBucket(
                    items=pairs,
                    batch_size=self.batch_size,
                    width=width,
                    height=height,
                    do_upscale=self.do_upscale,
                    num_repeats=self.num_repeats,
                    caption_processors=self.caption_processors,
                )
            )
        return buckets

    def get_dataset(self) -> ConcatDataset:
        buckets = self.generate_buckets()
        print_arb_info(buckets)
        return ConcatDataset([BucketDataset(bucket) for bucket in buckets])
