from .util import CaptionPassthrough, CaptionProcessorMixin
from .shuffle import CaptionShuffle, CaptionShuffleInGroup
from .append import (
    CaptionPrefix,
    CaptionRandomPrefix,
    CaptionRandomSuffix,
    CaptionSuffix,
)
from .drop import CaptionDrop, CaptionTagDrop
from .replace import CaptionReplace

CaptionProcessorList = list[
    CaptionPassthrough
    | CaptionPrefix
    | CaptionSuffix
    | CaptionRandomPrefix
    | CaptionRandomSuffix
    | CaptionShuffle
    | CaptionShuffleInGroup
    | CaptionDrop
    | CaptionTagDrop
    | CaptionReplace
]

__all__ = [
    "CaptionProcessorMixin",
    "CaptionPassthrough",
    "CaptionPrefix",
    "CaptionSuffix",
    "CaptionRandomPrefix",
    "CaptionRandomSuffix",
    "CaptionShuffle",
    "CaptionShuffleInGroup",
    "CaptionDrop",
    "CaptionTagDrop",
    "CaptionReplace",
    "CaptionProcessorList",
]
