"""Model saving: the cadence strategy, the callback registry, the
safetensors callback and the Hugging Face Hub callback
(``vision_ft_tpu/saving`` counterpart)."""

from typing import Union

from .hf_hub import HFHubSavingCallback, HFHubSavingCallbackConfig
from .safetensors import SafetensorsSavingCallback, SafetensorsSavingCallbackConfig
from .util import (
    ModelSavingCallback,
    ModelSavingCallbackConfig,
    ModelSavingStrategy,
    ModelSavingStrategyConfig,
)

ModelSavingCallbackConfgiAlias = Union[  # the name's spelling is the JAX package's
    SafetensorsSavingCallbackConfig, HFHubSavingCallbackConfig
]


def get_saving_callback(config: ModelSavingCallbackConfgiAlias, **kwargs) -> ModelSavingCallback:
    if isinstance(config, HFHubSavingCallbackConfig):
        return HFHubSavingCallback.from_config(config, **kwargs)
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
    "HFHubSavingCallback",
    "HFHubSavingCallbackConfig",
    "get_saving_callback",
]
