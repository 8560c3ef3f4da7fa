"""Host-side data loading (``vision_ft_tpu/dataloader.py`` counterpart).

A batch_size=1 loader over bucket datasets (each item already a full
batch) with concat-collate, plus a flatten-collate preview loader: a plain
Python iterator, synchronous or with a thread pool prefetching items;
per-epoch shuffling from ``random.Random(seed + epoch)``, the JAX package's
order. One process reads every batch (the JAX package's stride by host
process belongs to the multi-device mesh, which is not ported).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np


def concatnate_collate_fn(batch: Iterable[dict[str, Any]]) -> dict:
    """Concatenate values across items (the name's spelling is the JAX
    package's)."""
    result = defaultdict(list)
    for d in batch:
        for key, value in d.items():
            result[key].append(value)
    new_batch = {}
    for key, value in result.items():
        if isinstance(value[0], np.ndarray):
            new_batch[key] = np.concatenate(value, axis=0)
        elif isinstance(value[0], list):
            new_batch[key] = sum(value, [])
        else:
            new_batch[key] = value
    return new_batch


def preview_batch_collate_fn(batch: Iterable[dict[str, Any]]) -> dict:
    result = defaultdict(list)
    for d in batch:
        for key, value in d.items():
            result[key].append(value)
    new_batch = {}
    for key, value in result.items():
        assert len(value) == 1, "Preview batch size must be 1"
        new_batch[key] = value[0]
    return new_batch


class DataLoader:
    """Minimal epoch iterator over an indexable dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        seed: int = 0,
        num_workers: int = 0,
        prefetch_factor: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or (lambda items: items)
        self.seed = seed
        self.epoch = 0
        # threaded prefetch: PIL/zlib decode releases the GIL, so a small thread
        # pool overlaps image decode with device compute
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 1)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> list[int]:
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(indices)
        return indices

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _chunks(self) -> list[list[int]]:
        indices = self._indices()
        chunks = []
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            chunks.append(chunk)
        return chunks

    def __iter__(self) -> Iterator[dict]:
        chunks = self._chunks()
        if self.num_workers <= 0:
            for chunk in chunks:
                yield self.collate_fn([self.dataset[i] for i in chunk])
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            window: deque = deque()
            it = iter(chunks)
            depth = self.prefetch_factor + 1
            for chunk in chunks[:depth]:
                next(it)
                window.append([pool.submit(self.dataset.__getitem__, i) for i in chunk])
            while window:
                futures = window.popleft()
                upcoming = next(it, None)
                if upcoming is not None:
                    window.append(
                        [pool.submit(self.dataset.__getitem__, i) for i in upcoming]
                    )
                yield self.collate_fn([f.result() for f in futures])


def get_dataloader_for_bucketing(
    dataset,
    shuffle: bool = True,
    num_workers: int = 0,
    drop_last: bool = False,
    seed: int = 0,
) -> DataLoader:
    """batch_size=1 + concat collate: each dataset item IS a bucket batch."""
    return DataLoader(
        dataset,
        batch_size=1,
        shuffle=shuffle,
        drop_last=drop_last,
        collate_fn=concatnate_collate_fn,
        seed=seed,
        num_workers=num_workers,
    )


def get_dataloader_for_preview(dataset, num_workers: int = 0) -> DataLoader:
    return DataLoader(
        dataset,
        batch_size=1,
        shuffle=False,
        collate_fn=preview_batch_collate_fn,
    )
