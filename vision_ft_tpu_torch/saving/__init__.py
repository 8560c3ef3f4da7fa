"""Model saving: the cadence strategy, the callback registry and the
safetensors callback (``vision_ft_tpu/saving`` counterpart). The Hugging
Face Hub callback is not ported: its config validates, and building the
callback raises ``NotImplementedError``."""

from typing import Union

from .safetensors import SafetensorsSavingCallback, SafetensorsSavingCallbackConfig
from .util import (
    ModelSavingCallback,
    ModelSavingCallbackConfig,
    ModelSavingStrategy,
    ModelSavingStrategyConfig,
)


class HFHubSavingCallbackConfig(SafetensorsSavingCallbackConfig):
    type: str = "hf_hub"

    hub_id: str
    dir_in_repo: str
    repo_type: str = "model"


ModelSavingCallbackConfgiAlias = Union[  # the name's spelling is the JAX package's
    SafetensorsSavingCallbackConfig, HFHubSavingCallbackConfig
]


def get_saving_callback(config: ModelSavingCallbackConfgiAlias, **kwargs) -> ModelSavingCallback:
    if isinstance(config, HFHubSavingCallbackConfig):
        raise NotImplementedError("the Hugging Face Hub saving callback is not ported")
    if isinstance(config, SafetensorsSavingCallbackConfig):
        return SafetensorsSavingCallback.from_config(config, **kwargs)
    raise ValueError(f"Unknown saving config: {config}")


__all__ = [
    "ModelSavingCallback",
    "ModelSavingCallbackConfig",
    "ModelSavingCallbackConfgiAlias",
    "ModelSavingStrategy",
    "ModelSavingStrategyConfig",
    "SafetensorsSavingCallback",
    "SafetensorsSavingCallbackConfig",
    "HFHubSavingCallbackConfig",
    "get_saving_callback",
]
