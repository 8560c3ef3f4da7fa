"""PEFT: LoRA / LoHa on the port's ``Linear`` and ``Conv2d`` layers
(``vision_ft_tpu/modules/peft`` counterpart).

The JAX package keeps adapters as extra param subtrees; here
``replace_to_peft_layer`` adds ``lora_down``/``lora_up`` (or ``hada_*``)
parameters and an ``alpha`` buffer to the targeted layers of a module, and
``nn.core.Linear`` / ``Conv2d`` apply them when present. The module's
``state_dict()`` keys stay those of the JAX tree flattened, so adapter
files are interchangeable.
"""

from typing import Literal, Optional, Union

from pydantic import BaseModel, field_validator

from ...utils.state_dict import RegexMatch
from .functional import (
    calculate_trainable_parameters,
    detect_peft_method,
    find_targetable_paths,
    get_adapter_parameters,
    load_peft_weight,
    merge_params,
    print_trainable_parameters,
    replace_to_peft_layer,
    split_peft_params,
    while_peft_disabled,
    while_peft_enabled,
)

PEFT_TYPE = Literal["lora", "loha", "none"]


class PeftConfigMixin(BaseModel):
    type: PEFT_TYPE
    dtype: str = "bfloat16"


class LoRAConfig(PeftConfigMixin):
    type: Literal["lora"] = "lora"
    rank: int
    alpha: float = 1.0
    dropout: float = 0.0
    use_bias: bool = False


class LoHaConfig(PeftConfigMixin):
    type: Literal["loha"] = "loha"
    rank: int
    alpha: float = 1.0
    dropout: float = 0.0


PeftConfigUnion = Union[LoRAConfig, LoHaConfig]


class PeftTargetConfig(BaseModel):
    """include/exclude key targeting + adapter config + optional resume
    weights."""

    include_keys: list[Union[str, RegexMatch]] = []
    exclude_keys: list[Union[str, RegexMatch]] = []

    config: PeftConfigUnion

    resume_weight_path: Optional[str] = None
    resume_rename_key_map: dict[str, str] = {}

    @field_validator("include_keys")
    @classmethod
    def check_include_keys(cls, v):
        if len(v) == 0:
            raise ValueError("include_keys must not be empty")
        return v

    def replace_to_peft_layer(self, module, generator, dtype=None):
        return replace_to_peft_layer(
            module,
            self.include_keys,
            self.exclude_keys,
            self.config,
            generator,
            dtype=dtype,
        )


__all__ = [
    "PEFT_TYPE",
    "PeftConfigMixin",
    "LoRAConfig",
    "LoHaConfig",
    "PeftConfigUnion",
    "PeftTargetConfig",
    "RegexMatch",
    "find_targetable_paths",
    "replace_to_peft_layer",
    "get_adapter_parameters",
    "split_peft_params",
    "merge_params",
    "load_peft_weight",
    "detect_peft_method",
    "calculate_trainable_parameters",
    "print_trainable_parameters",
    "while_peft_disabled",
    "while_peft_enabled",
]
