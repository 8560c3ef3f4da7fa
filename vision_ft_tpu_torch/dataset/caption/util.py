"""Caption processor base (``vision_ft_tpu/dataset/caption/util.py`` counterpart).

Composable pydantic string transforms, discriminated by ``type:`` in YAML.
Randomized processors use the global ``random`` module like the JAX package
(seed via random.seed for reproducibility).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Literal

from pydantic import BaseModel


class CaptionProcessorMixin(ABC, BaseModel):
    type: str

    @abstractmethod
    def process(self, caption: str) -> str:
        ...

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.process(*args, **kwargs)


class CaptionPassthrough(CaptionProcessorMixin):
    type: Literal["passthrough"] = "passthrough"

    def process(self, caption: str) -> str:
        return caption
