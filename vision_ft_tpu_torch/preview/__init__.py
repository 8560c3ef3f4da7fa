"""Previews: the cadence strategy, the callback registry, the local file
callback and the Discord webhook callback (``vision_ft_tpu/preview``
counterpart)."""

from typing import Union

from .discord import DiscordWebhookPreviewCallback, DiscordWebhookPreviewCallbackConfig
from .local import LocalPreviewCallback, LocalPreviewCallbackConfig
from .util import (
    PreviewCallback,
    PreviewCallbackConfig,
    PreviewStrategy,
    PreviewStrategyConfig,
)

PreviewCallbackConfigAlias = Union[
    LocalPreviewCallbackConfig, DiscordWebhookPreviewCallbackConfig
]


def get_preview_callback(config: PreviewCallbackConfigAlias, **kwargs) -> PreviewCallback:
    if isinstance(config, LocalPreviewCallbackConfig):
        return LocalPreviewCallback.from_config(config, **kwargs)
    if isinstance(config, DiscordWebhookPreviewCallbackConfig):
        return DiscordWebhookPreviewCallback.from_config(config, **kwargs)
    raise ValueError(f"Unknown preview config: {config}")


__all__ = [
    "PreviewCallback",
    "PreviewCallbackConfig",
    "PreviewCallbackConfigAlias",
    "PreviewStrategy",
    "PreviewStrategyConfig",
    "LocalPreviewCallback",
    "LocalPreviewCallbackConfig",
    "DiscordWebhookPreviewCallback",
    "DiscordWebhookPreviewCallbackConfig",
    "get_preview_callback",
]
