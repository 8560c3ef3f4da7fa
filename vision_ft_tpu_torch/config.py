"""Train config schema (``vision_ft_tpu/config.py`` counterpart).

The same pydantic tree as the JAX package, so one YAML file drives both:
``model`` and ``dataset`` stay dicts for two-stage validation by the
workload class; discriminated unions for saving, preview and PEFT; the
``trainer`` section keeps every field of the JAX package's, and the
Trainer raises ``NotImplementedError`` on a mesh of more than one device,
which is not ported. YAML is read with PyYAML, imported where a file is
read.
"""

from __future__ import annotations

from typing import Literal, Optional, Union

from pydantic import BaseModel

from .dataset.preview import TextToImagePreviewConfig
from .modules.peft import PeftTargetConfig
from .preview import PreviewCallbackConfigAlias, PreviewStrategyConfig
from .saving import (
    ModelSavingCallbackConfgiAlias,
    ModelSavingStrategyConfig,
    SafetensorsSavingCallbackConfig,
)

PreviewDatasetAlias = TextToImagePreviewConfig


class OptimizerConfig(BaseModel):
    name: str = "torch.optim.AdamW"
    args: dict = {"lr": 1e-3}


class SchedulerConfig(BaseModel):
    name: str = "torch.optim.lr_scheduler.ConstantLR"
    args: dict = {}


class SavingConfig(BaseModel):
    strategy: ModelSavingStrategyConfig = ModelSavingStrategyConfig()
    callbacks: list[ModelSavingCallbackConfgiAlias] = [
        SafetensorsSavingCallbackConfig(name="model", save_dir="./output")
    ]
    rename_key_map: dict[str, str] = {}


class PreviewConfig(BaseModel):
    strategy: PreviewStrategyConfig = PreviewStrategyConfig()
    callbacks: list[PreviewCallbackConfigAlias] = []
    data: PreviewDatasetAlias


class TrackerConfig(BaseModel):
    project_name: str
    loggers: list[Literal["wandb", "tensorboard"]]


DEBUG_MODE_TYPE = Literal[False, "sanity_check", "1step", "dataset"]


class MeshConfigSchema(BaseModel):
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    pipeline_microbatches: int = 1


class TrainerConfig(BaseModel):
    debug_mode: DEBUG_MODE_TYPE = False

    # accepted for config compatibility; the port runs eagerly
    torch_compile: bool = False
    torch_compile_args: dict = {}

    gradient_checkpointing: bool = False
    # what gradient checkpointing keeps across the forward/backward
    # boundary (nn.core.set_remat_saves): "activations" (the JAX package's
    # default) keeps the kernels' outputs and every Linear / Conv2d
    # product, "kernel" the flash kernels' (out, lse) only, "none" nothing
    # (the gradients are the same in every mode)
    remat_saves: Literal["activations", "kernel", "none"] = "activations"
    remat_group: int = 1
    gradient_accumulation_steps: int = 1

    clip_grad_norm: Optional[float] = None
    clip_grad_value: Optional[float] = None

    fp32_matmul_precision: Optional[Literal["highest", "high", "medium"]] = None
    allow_tf32: bool = False

    # the device mesh: {data, fsdp, tensor} sizes; the port runs on one
    # device, and anything that asks for more raises
    mesh: MeshConfigSchema = MeshConfigSchema()

    profile: bool = False
    profile_dir: str = "profiles"
    profile_start_step: int = 1
    profile_stop_step: int = 3

    debug_nans: bool = False

    state_checkpoint_dir: Optional[str] = None
    state_checkpoint_every_steps: int = 100
    resume_from_state_checkpoint: bool = True

    ema_decay: Optional[float] = None


class TrainConfig(BaseModel):
    model: Union[dict, BaseModel]
    dataset: Union[dict, BaseModel]
    peft: Union[PeftTargetConfig, list[PeftTargetConfig], None] = None

    optimizer: OptimizerConfig = OptimizerConfig()
    scheduler: Optional[SchedulerConfig] = None
    saving: Optional[SavingConfig] = SavingConfig()
    preview: Optional[PreviewConfig] = None
    tracker: Optional[TrackerConfig] = None
    trainer: TrainerConfig = TrainerConfig()

    seed: int = 42
    num_train_epochs: int = 1

    @staticmethod
    def from_config_file(path: str) -> "TrainConfig":
        import yaml

        with open(path) as f:
            config = yaml.safe_load(f)
        return TrainConfig.model_validate(config, strict=True)
