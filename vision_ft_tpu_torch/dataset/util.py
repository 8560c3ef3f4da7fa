"""Dataset config base + concat dataset (``vision_ft_tpu/dataset/util.py``
counterpart): datasets are plain Python sequence objects whose
``__getitem__`` returns an already-collated batch dict of numpy arrays /
lists.
"""

from __future__ import annotations

import bisect
from abc import ABC, abstractmethod
from typing import Any, Sequence

from pydantic import BaseModel


class DatasetConfig(BaseModel, ABC):
    batch_size: int = 32
    shuffle: bool = True
    num_workers: int = 8

    @abstractmethod
    def get_dataset(self):
        ...


class ConcatDataset:
    """Sequence concatenation (torch ConcatDataset without torch)."""

    def __init__(self, datasets: Sequence[Any]):
        assert len(datasets) > 0, "datasets must not be empty"
        self.datasets = list(datasets)
        self.cumulative_sizes: list[int] = []
        total = 0
        for ds in self.datasets:
            total += len(ds)
            self.cumulative_sizes.append(total)

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        if idx < 0:
            idx += len(self)
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]
