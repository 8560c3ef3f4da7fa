"""The port's datasets and dataloaders against the JAX package's (CPU):
aspect-ratio buckets, caption processors, tag formatting, the
text-to-image folder dataset and its batches, the preview dataset, and the
synchronous and prefetched loaders. The same folder and the same seeds
(the global ``random`` module for captions, a numpy generator for crops)
must give the same batches in both packages.
"""

import json
import random

import numpy as np
import pytest
from PIL import Image

from vision_ft_tpu import dataloader as jax_dataloader
from vision_ft_tpu.dataset import aspect_ratio_bucket as jax_arb
from vision_ft_tpu.dataset import caption as jax_caption
from vision_ft_tpu.dataset import tags as jax_tags
from vision_ft_tpu.dataset.preview import TextToImagePreviewConfig as JaxPreviewConfig
from vision_ft_tpu.dataset.text_to_image import TextToImageDatasetConfig as JaxDatasetConfig

from vision_ft_tpu_torch import dataloader
from vision_ft_tpu_torch.dataset import aspect_ratio_bucket as arb
from vision_ft_tpu_torch.dataset import caption
from vision_ft_tpu_torch.dataset import tags
from vision_ft_tpu_torch.dataset.preview import TextToImagePreviewConfig
from vision_ft_tpu_torch.dataset.text_to_image import TextToImageDatasetConfig
from test_torch_nn import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("base,step,min_size", [(1024, 128, 384), (1024, 64, 384), (64, 32, 32)])
def test_buckets_and_nearest_bucket_match_jax(base, step, min_size):
    want = jax_arb.generate_buckets(base * base, base, step, min_size)
    got = arb.generate_buckets(base * base, base, step, min_size)
    np.testing.assert_array_equal(got, want)
    manager, jax_manager = arb.AspectRatioBucketManager(got), jax_arb.AspectRatioBucketManager(want)
    rng = np.random.default_rng(0)
    for w, h in rng.integers(base, 2 * base, (50, 2)):  # no smaller than the largest bucket
        assert manager.find_nearest(int(w), int(h)) == jax_manager.find_nearest(int(w), int(h))


PROCESSORS = [
    {"type": "shuffle", "split_separator": ","},
    {"type": "shuffle_in_group"},
    {"type": "drop", "drop_rate": 0.5},
    {"type": "tag_drop", "drop_rate": 0.3},
    {"type": "prefix", "prefix": "best, "},
    {"type": "suffix", "suffix": ", done"},
    {"type": "prefix_random", "prefix": ["a, ", "b, ", "c, "]},
    {"type": "suffix_random", "suffix": [", x", ", y"]},
    {"type": "replace", "source": "red", "target": "blue"},
    {"type": "passthrough"},
]


@pytest.mark.parametrize("spec", PROCESSORS, ids=[p["type"] for p in PROCESSORS])
def test_caption_processors_match_jax(spec):
    from pydantic import TypeAdapter

    ours = TypeAdapter(caption.CaptionProcessorList).validate_python([spec])[0]
    theirs = TypeAdapter(jax_caption.CaptionProcessorList).validate_python([spec])[0]
    assert type(ours).__name__ == type(theirs).__name__
    text = "1girl, red hair, smile ||| solo, outdoors, red sky, day"
    for seed in range(5):
        random.seed(seed)
        got = ours(text)
        random.seed(seed)
        assert got == theirs(text)


def test_tag_formatting_matches_jax():
    general = ["1girl", "red_hair", ">_<", "smile", "2boys"]
    args = dict(general=tags.map_replace_underscore(general), character=["hatsune_miku"], rating="q")
    jax_args = dict(general=jax_tags.map_replace_underscore(general), character=["hatsune_miku"],
                    rating="q")
    assert tags.format_general_character_tags(**args) == jax_tags.format_general_character_tags(**jax_args)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Images larger than their buckets (so crops are drawn), captions as
    .txt files and as danbooru-style .json metadata, one skipped image."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("images")
    sizes = [(80, 72)] * 5 + [(40, 150)] * 3 + [(90, 90)]
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(root / f"{i:02}.png")
        if i % 3 == 0:
            meta = {"tag_string": "x", "tag_string_general": "1girl red_hair smile",
                    "tag_string_character": "miku", "tag_string_copyright": "vocaloid",
                    "rating": "g", "skip": i == 8}
            (root / f"{i:02}.json").write_text(json.dumps(meta))
        else:
            (root / f"{i:02}.txt").write_text(f"photo {i}, red, blue, green")
    return root


def _config(folder, **more):
    return {"folder": str(folder), "batch_size": 2, "bucket_base_size": 64, "step": 32,
            "min_size": 32, "num_repeats": 2, "num_workers": 0,
            "caption_processors": [{"type": "shuffle"}, {"type": "tag_drop", "drop_rate": 0.2}],
            **more}


def _batches(config_class, loader_module, folder, seed, **more):
    dataset = config_class.model_validate(_config(folder, **more)).get_dataset()
    for ds in dataset.datasets:
        ds.bucket.rng = np.random.default_rng(seed)  # the crops' generator
    loader = loader_module.get_dataloader_for_bucketing(dataset, shuffle=True, seed=seed)
    random.seed(seed)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.extend(loader)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if isinstance(w[key], np.ndarray):
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            else:
                assert g[key] == w[key], key


def test_text_to_image_batches_match_jax(folder):
    """Two epochs of the bucketing loader over the folder: images, sizes,
    crops, captions, widths and heights equal batch for batch."""
    want = _batches(JaxDatasetConfig, jax_dataloader, folder, seed=3)
    got = _batches(TextToImageDatasetConfig, dataloader, folder, seed=3)
    _assert_batches_equal(got, want)
    assert len(got) == 18  # 8 kept images in 2 buckets, 2 repeats: 9 batches of 2 an epoch
    assert {b["image"].shape[1:3] for b in got} == {(64, 64), (32, 128)}
    assert any("miku" in c for b in got for c in b["caption"])


def test_prefetched_loader_gives_the_synchronous_batches(folder):
    """Threads prefetch whole batches; without random caption processors
    the batches are those of the synchronous loader."""
    kwargs = dict(caption_processors=[])
    dataset = TextToImageDatasetConfig.model_validate(_config(folder, **kwargs)).get_dataset()
    for ds in dataset.datasets:
        ds.bucket.rng = np.random.default_rng(0)
    sync = list(dataloader.get_dataloader_for_bucketing(dataset, seed=1))
    for ds in dataset.datasets:
        ds.bucket.rng = np.random.default_rng(0)
    threaded = list(dataloader.get_dataloader_for_bucketing(dataset, seed=1, num_workers=2))
    assert len(sync) == len(threaded) == 9
    for a, b in zip(sync, threaded):
        assert a["caption"] == b["caption"]
        assert a["image"].shape == b["image"].shape


def test_preview_dataset_matches_jax():
    path = "configs/sdxl/preview.yml"
    got = dataloader.get_dataloader_for_preview(
        TextToImagePreviewConfig(path=path).get_dataset())
    want = jax_dataloader.get_dataloader_for_preview(JaxPreviewConfig(path=path).get_dataset())
    got, want = list(got), list(want)
    assert got == want and len(got) == 1 and got[0]["width"] == 1024
