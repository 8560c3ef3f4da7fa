"""Previews: the cadence strategy, the callback registry and the local
file callback (``vision_ft_tpu/preview`` counterpart). The Discord webhook
callback is not ported: its config validates, and building the callback
raises ``NotImplementedError``."""

from typing import Literal, Optional, Union

from pydantic import BaseModel, SecretStr

from .local import LocalPreviewCallback, LocalPreviewCallbackConfig
from .util import (
    PreviewCallback,
    PreviewCallbackConfig,
    PreviewStrategy,
    PreviewStrategyConfig,
)


class DiscordWebhookPreviewCallbackConfig(BaseModel):
    type: Literal["discord"] = "discord"
    url: SecretStr

    username: Optional[str] = None
    avatar_url: Optional[str] = None

    message_template: str = """\
- Epoch: `{epoch}`
- Steps: `{steps}`
- Preview ID: `{id}`"""


PreviewCallbackConfigAlias = Union[
    LocalPreviewCallbackConfig, DiscordWebhookPreviewCallbackConfig
]


def get_preview_callback(config: PreviewCallbackConfigAlias, **kwargs) -> PreviewCallback:
    if isinstance(config, LocalPreviewCallbackConfig):
        return LocalPreviewCallback.from_config(config, **kwargs)
    if isinstance(config, DiscordWebhookPreviewCallbackConfig):
        raise NotImplementedError("the Discord webhook preview callback is not ported")
    raise ValueError(f"Unknown preview config: {config}")


__all__ = [
    "PreviewCallback",
    "PreviewCallbackConfig",
    "PreviewCallbackConfigAlias",
    "PreviewStrategy",
    "PreviewStrategyConfig",
    "LocalPreviewCallback",
    "LocalPreviewCallbackConfig",
    "DiscordWebhookPreviewCallbackConfig",
    "get_preview_callback",
]
