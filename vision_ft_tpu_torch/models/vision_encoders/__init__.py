from .clip_vision import (
    CLIPVisionConfig,
    CLIPVisionModel,
    CLIPVisionModelWithProjection,
)

__all__ = [
    "CLIPVisionConfig",
    "CLIPVisionModel",
    "CLIPVisionModelWithProjection",
]
