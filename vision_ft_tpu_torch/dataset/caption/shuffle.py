"""Caption shuffle processors (``vision_ft_tpu/dataset/caption/shuffle.py`` counterpart)."""

from __future__ import annotations

import random
from typing import Literal

from .util import CaptionProcessorMixin


class CaptionShuffle(CaptionProcessorMixin):
    type: Literal["shuffle"] = "shuffle"
    split_separator: str = ","
    trim: bool = True
    concat_separator: str = ", "

    def process(self, caption: str) -> str:
        items = [
            item.strip() if self.trim else item
            for item in caption.split(self.split_separator)
        ]
        random.shuffle(items)
        return self.concat_separator.join(items)


class CaptionShuffleInGroup(CaptionProcessorMixin):
    """Shuffle within ``|||``-separated groups, preserving group order."""

    type: Literal["shuffle_in_group"] = "shuffle_in_group"
    group_separator: str = "|||"
    split_separator: str = ","
    trim: bool = True
    concat_separator: str = ", "

    def shuffle(self, group: str) -> str:
        items = [
            item.strip() if self.trim else item
            for item in group.split(self.split_separator)
        ]
        random.shuffle(items)
        return self.concat_separator.join(items)

    def process(self, caption: str) -> str:
        groups = caption.split(self.group_separator)
        return self.concat_separator.join(self.shuffle(g) for g in groups)
