"""Kyara dataset: character-reference pairs with body-part detections
(``vision_ft_tpu/dataset/kyara.py`` counterpart).

Each image belongs to a character group (parquet ``id`` -> ``group``
list); at fetch time a random group member's detection (head / upper
body / full body, weighted, with a recursive fallback) gives the cropped
reference image, and the target's caption is its whole-image tags minus
the detection's tags (so the model must take that identity information
from the reference image).

As in the JAX package, the crop is normalized to [-1, 1] first and padded
afterwards, so ``background_color`` is a fill value in normalized space.
The parquet is read through ``pyarrow``, imported when the pairs are
read; items stay a plain list.
"""

from __future__ import annotations

import json
import random
import warnings
from collections import defaultdict
from functools import reduce
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
from PIL import Image
from pydantic import BaseModel

from .aspect_ratio_bucket import AspectRatioBucketConfig, AspectRatioBucketManager
from .bucket import BucketDataset
from .caption import CaptionProcessorList
from .tags import format_general_character_tags
from .text_to_image import ImageCaptionPair, TextToImageBucket, get_image_size
from .transform import to_array
from .util import ConcatDataset


class Coords(BaseModel):
    top: int
    left: int
    right: int
    bottom: int
    width: int
    height: int


class Tags(BaseModel):
    rating: str
    general: list[str]
    characters: list[str]


class Detection(BaseModel):
    coords: Coords
    tags: Tags


class KyaraDetections(BaseModel):
    heads: list[Detection]
    upper_bodies: list[Detection]
    full_bodies: list[Detection]

    whole_image_tags: Tags


class DetectionSamplingWeights(NamedTuple):
    head: float = 0.5
    upper_body: float = 1.0
    full_body: float = 0.5


class KyaraImageCaptionPair(ImageCaptionPair):
    same_group_ids: list[str]


def read_kyara_detections(directory: Path, id: str) -> Optional[KyaraDetections]:
    json_path = Path(directory) / f"{id}.json"
    if not json_path.exists():
        return None
    with open(json_path) as f:
        return KyaraDetections.model_validate(json.load(f))


class KyaraBucket(TextToImageBucket):
    def __init__(
        self,
        reference_size: int,
        background_color: int,
        image_directory: Path,
        sampling_weights: DetectionSamplingWeights = DetectionSamplingWeights(),
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.reference_size = reference_size
        self.background_color = background_color
        self.image_directory = Path(image_directory)
        self.sampling_weights = sampling_weights

    # -- reference-image preparation -----------------------------------------

    def _reference_transform(self, img: Image.Image) -> np.ndarray:
        """Normalize to [-1, 1], then pad: the pad fill is
        ``background_color`` verbatim in normalized space."""
        w, h = img.size
        scale = self.reference_size / max(w, h)
        new_w = max(round(w * scale), 1)
        new_h = max(round(h * scale), 1)
        resized = img.convert("RGB").resize((new_w, new_h), Image.BILINEAR)
        arr = to_array(resized)  # already [-1, 1]
        canvas = np.full(
            (self.reference_size, self.reference_size, 3),
            float(self.background_color),
            np.float32,
        )
        top = (self.reference_size - new_h) // 2
        left = (self.reference_size - new_w) // 2
        canvas[top : top + new_h, left : left + new_w] = arr
        return canvas

    def choice_detection(
        self,
        detections: KyaraDetections,
        weights: list[float],
        choices: Optional[list[str]] = None,
    ) -> Optional[Detection]:
        """A weighted pick of a detection kind, falling back to the others
        (recursively) where the picked kind has none."""
        choices = choices or ["head", "upper_body", "full_body"]
        choice = random.choices(choices, weights=weights, k=1)[0]
        pool = {
            "head": detections.heads,
            "upper_body": detections.upper_bodies,
            "full_body": detections.full_bodies,
        }[choice]
        if pool:
            return random.choice(pool)
        remaining = [(c, w) for c, w in zip(choices, weights) if c != choice]
        if not remaining:
            return None
        return self.choice_detection(
            detections, [w for _, w in remaining], [c for c, _ in remaining]
        )

    def prepare_caption(self, pair: KyaraImageCaptionPair):
        """(group_id, caption, crop coords)."""
        id_ = pair.image.stem
        group_id = random.choice(pair.same_group_ids)
        self_detections = read_kyara_detections(self.image_directory, str(id_))
        assert self_detections is not None, f"Detections for id {id_} not found."
        ref_detections = read_kyara_detections(self.image_directory, str(group_id))
        assert ref_detections is not None, f"Detections for id {group_id} not found."

        weights = list(self.sampling_weights)
        detection = self.choice_detection(ref_detections, weights)
        general = (
            detection.tags.general
            if detection is not None
            else ref_detections.whole_image_tags.general
        )
        coords = (
            (
                detection.coords.left,
                detection.coords.top,
                detection.coords.right,
                detection.coords.bottom,
            )
            if detection is not None
            else None
        )

        whole = self_detections.whole_image_tags
        final_general = list(set(whole.general) - set(general))
        caption = format_general_character_tags(
            rating=whole.rating, general=final_general, character=[]
        )
        return group_id, caption, coords

    def __getitem__(self, idx):
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        pairs: list[KyaraImageCaptionPair] = super(
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

            group_id, caption, coords = self.prepare_caption(pair)
            ref_path = self.image_directory / f"{group_id}.webp"
            if not ref_path.exists():
                # same id, any supported extension
                for candidate in self.image_directory.glob(f"{group_id}.*"):
                    if candidate.suffix != ".json":
                        ref_path = candidate
                        break
            with Image.open(ref_path) as ref:
                ref = ref.convert("RGB")
                if coords is not None:
                    ref = ref.crop(coords)
                reference_images.append(self._reference_transform(ref))
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


class KyaraDatasetConfig(AspectRatioBucketConfig):
    """The Kyara dataset's configuration: the image folder (images and
    their detection JSONs) and the group parquet."""

    folder: str
    group_parquet_path: str

    supported_extensions: list[str] = [".png", ".jpg", ".jpeg", ".webp", ".avif"]
    caption_extension: str = ".txt"
    metadata_extension: str = ".json"

    image_size: int = 448
    background_color: int = 0
    weight_head: float = 0.5
    weight_upper_body: float = 1.0
    weight_full_body: float = 0.5

    do_upscale: bool = False
    num_repeats: int = 1
    caption_processors: CaptionProcessorList = []

    def get_image_file_by_id(self, id: str) -> Optional[Path]:
        directory = Path(self.folder)
        for ext in self.supported_extensions:
            file = directory / f"{id}{ext}"
            if file.exists():
                return file
        return None

    def _retrive_images(self) -> list[KyaraImageCaptionPair]:
        import pyarrow.parquet as pq

        pairs: list[KyaraImageCaptionPair] = []
        table = pq.read_table(self.group_parquet_path)
        for row in table.to_pylist():
            id_ = row["id"]
            group_ids = row["group"]
            image_path = self.get_image_file_by_id(str(id_))
            if image_path is None:
                raise FileNotFoundError(f"Image file for id {id_} not found.")
            metadata_path = image_path.with_suffix(self.metadata_extension)
            assert metadata_path.exists(), f"Metadata file {metadata_path} not found."
            width, height = get_image_size(image_path)
            pair = KyaraImageCaptionPair(
                image=image_path,
                width=width,
                height=height,
                caption=None,
                metadata=metadata_path,
                same_group_ids=[str(g) for g in group_ids],
            )
            if pair.should_skip:
                continue
            pairs.append(pair)
        return pairs

    def generate_buckets(self) -> list[KyaraBucket]:
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
                KyaraBucket(
                    items=pairs,
                    batch_size=self.batch_size,
                    width=width,
                    height=height,
                    do_upscale=self.do_upscale,
                    num_repeats=self.num_repeats,
                    caption_processors=self.caption_processors,
                    reference_size=self.image_size,
                    background_color=self.background_color,
                    image_directory=Path(self.folder),
                    sampling_weights=DetectionSamplingWeights(
                        head=self.weight_head,
                        upper_body=self.weight_upper_body,
                        full_body=self.weight_full_body,
                    ),
                )
            )
        return buckets

    def get_dataset(self):
        buckets = self.generate_buckets()
        return ConcatDataset([BucketDataset(bucket) for bucket in buckets])
