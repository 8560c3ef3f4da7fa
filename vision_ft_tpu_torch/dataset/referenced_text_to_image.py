"""Referenced text-to-image dataset for IP-Adapter training
(``vision_ft_tpu/dataset/referenced_text_to_image.py`` counterpart).

Each sample pairs an image with a reference image (a random other image
of the same character, named by a metadata parquet with tag columns);
captions are composed from shuffled tag groups; reference images are
PaddedResize'd to a square. The parquet is read through ``pyarrow``,
imported when the pairs are read.
"""

from __future__ import annotations

import random
import warnings
from collections import defaultdict
from functools import reduce
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from PIL import Image
from pydantic import BaseModel

from .aspect_ratio_bucket import AspectRatioBucketManager
from .bucket import BucketDataset
from .text_to_image import (
    ImageCaptionPair,
    TextToImageBucket,
    TextToImageDatasetConfig,
    get_image_size,
)
from .transform import PaddedResize, to_array
from .util import ConcatDataset


def _shuffle(lst):
    random.shuffle(lst)
    return lst


def compose_caption(copyright, character, general, meta, people) -> str:
    """people, characters, copyrights, then general + meta tags, each
    group shuffled."""
    return ", ".join(
        [
            *_shuffle(list(people)),
            *_shuffle(list(character)),
            *_shuffle(list(copyright)),
            *_shuffle(list(general) + list(meta)),
        ]
    )


class ImageCaptionPairWithReference(ImageCaptionPair):
    reference_image: Path

    copyright: list[str]
    character: list[str]
    general: list[str]
    meta: list[str]
    people: list[str]

    def read_caption(self) -> str:
        raise NotImplementedError(
            "read_caption() is not implemented for ImageCaptionPairWithReference."
        )


class ReferencedTextToImageBucket(TextToImageBucket):
    def __init__(self, reference_size: int, background_color: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.reference_resize = PaddedResize(
            max_size=reference_size, fill=background_color
        )

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        pairs: list[ImageCaptionPairWithReference] = super(
            TextToImageBucket, self
        ).__getitem__(idx)

        images, original_size, target_size, crops = [], [], [], []
        reference_images, captions = [], []
        for pair in pairs:
            with Image.open(pair.image) as img:
                arr = to_array(self.resize(img))
            cropped, top, left = self._random_crop(arr)
            images.append(cropped)
            original_size.append([arr.shape[0], arr.shape[1]])
            target_size.append([self.height, self.width])
            crops.append([top, left])
            with Image.open(pair.reference_image) as ref:
                reference_images.append(to_array(self.reference_resize(ref)))
            caption = compose_caption(
                pair.copyright, pair.character, pair.general, pair.meta, pair.people
            )
            caption = reduce(lambda c, p: p(c), self.caption_processors, caption)
            captions.append(caption)

        return {
            "image": np.stack(images),
            "original_size": np.asarray(original_size, np.float32),
            "target_size": np.asarray(target_size, np.float32),
            "crop_coords_top_left": np.asarray(crops, np.float32),
            "reference_image": np.stack(reference_images),
            "caption": captions,
            "width": [self.width] * len(pairs),
            "height": [self.height] * len(pairs),
        }


class ReferencedTextToImageDatasetConfig(TextToImageDatasetConfig):
    metadata_parquet: str

    image_size: int = 384
    background_color: int = 0

    def _retrive_images(self) -> list[ImageCaptionPairWithReference]:
        import pyarrow.parquet as pq

        images_path = Path(self.folder)
        table = pq.read_table(self.metadata_parquet)
        pairs: list[ImageCaptionPairWithReference] = []
        for row in table.to_pylist():
            id_ = row["id"]
            image_path = images_path / f"{id_}.webp"
            if not image_path.exists():
                raise FileNotFoundError(f"Image {image_path} not found for image {id_}")
            candidates = [a for a in row["another_id"] if a != id_]
            another_id = random.choice(candidates)
            reference_path = images_path / f"{another_id}.webp"
            if not reference_path.exists():
                raise FileNotFoundError(
                    f"Reference image {reference_path} not found for image {id_}"
                )
            width, height = get_image_size(image_path)
            pairs.append(
                ImageCaptionPairWithReference(
                    image=image_path,
                    width=width,
                    height=height,
                    caption=None,
                    reference_image=reference_path,
                    copyright=row["copyright"],
                    character=row["character"],
                    general=row["general"],
                    meta=row["meta"],
                    people=row["people"],
                )
            )
        return pairs

    def generate_buckets(self) -> list[ReferencedTextToImageBucket]:
        arb_manager = AspectRatioBucketManager(self.buckets)
        bucket_subsets = defaultdict(list)
        for pair in self._retrive_images():
            try:
                bucket_idx = arb_manager.find_nearest(pair.width, pair.height)
                bucket_subsets[bucket_idx].append(pair)
            except AssertionError:
                warnings.warn(
                    f"Image size {pair.width}x{pair.height} is too small. Skipping...",
                    UserWarning,
                )
        buckets = []
        for bucket_idx, pairs in bucket_subsets.items():
            if not pairs:
                continue
            width, height = self.buckets[bucket_idx]
            buckets.append(
                ReferencedTextToImageBucket(
                    items=pairs,
                    batch_size=self.batch_size,
                    width=width,
                    height=height,
                    do_upscale=self.do_upscale,
                    num_repeats=self.num_repeats,
                    caption_processors=self.caption_processors,
                    reference_size=self.image_size,
                    background_color=self.background_color,
                )
            )
        return buckets
