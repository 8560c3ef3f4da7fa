"""Abstract per-workload model wrapper (``vision_ft_tpu/models/for_training.py``
counterpart): the lifecycle hooks (before/after setup, sanity check,
preprocessing, the loss, previews, saving) and buffered step/epoch
logging.

The JAX package's pure ``loss_fn(trainable, frozen, batch, key)`` is here
``loss_fn(batch, generator) -> (loss, metrics)`` over the model's own
modules, which hold both parameter sets: it is what
``training.make_train_step`` takes. The parameters are one
``nn.ModuleDict`` (:meth:`get_params`) keyed as the JAX package's tree
flattens (``denoiser.*``, ``vae.*``, ``text_encoder.*``), so PEFT
targeting and the trainable/frozen split see the same keys in both
packages.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

import numpy as np
import torch
from pydantic import BaseModel
from torch import nn

from ..config import TrainConfig


class ModelForTraining(ABC):
    model_config: BaseModel
    model_config_class: type[BaseModel]

    model: Any  # the pipeline object (e.g. SDXLModel)

    def __init__(self, trainer: Any, config: TrainConfig) -> None:
        self.trainer = trainer
        self.config = config
        self._current_step = 0
        self._logs_at_step: dict = {}
        self._logs_at_epoch: dict[str, list] = {}
        self._is_peft = False
        self.validate_config()

    def validate_config(self) -> None:
        self.model_config = self.model_config_class.model_validate(self.config.model)

    def _set_is_peft(self, is_peft: bool) -> None:
        self._is_peft = is_peft

    # -- parameters ----------------------------------------------------------

    def get_params(self) -> nn.Module:
        """Every module of the wrapped pipeline, one ``nn.ModuleDict`` (the
        modules themselves, not copies)."""
        return self.model.as_module()

    def trainable_filter(self, path: str) -> bool:
        """Full fine-tune split: which parameters train when no PEFT config
        is present. Default: the denoiser trains, the text encoders and the
        VAE are frozen."""
        return path.startswith("denoiser.")

    def peft_extra_trainable_filter(self, path: str) -> bool:
        """Parameters that stay fully trainable even under a PEFT config.
        Default: none."""
        return False

    def load_peft_weights(self) -> None:
        """Resume adapters (``PeftTargetConfig.resume_weight_path``)."""
        from ..modules.peft import load_peft_weight
        from ..utils import safetensors as st

        peft = self.config.peft
        targets = peft if isinstance(peft, list) else [peft] if peft else []
        for target in targets:
            if target.resume_weight_path is not None:
                state_dict = st.load_file_with_rename_key_map(
                    target.resume_weight_path, target.resume_rename_key_map
                )
                load_peft_weight(self.get_params(), state_dict)

    # -- lifecycle hooks -------------------------------------------------------

    @abstractmethod
    def before_setup_model(self) -> None:
        ...

    @abstractmethod
    def setup_model(self) -> None:
        ...

    def after_setup_model(self) -> None:
        pass

    @abstractmethod
    def sanity_check(self) -> None:
        ...

    # -- the training interface ------------------------------------------------

    def preprocess_batch(self, batch: dict) -> dict:
        """Host-side batch preparation (tokenize captions, fill caches):
        returns the tensors the loss reads, on the model's device."""
        return batch

    @abstractmethod
    def loss_fn(self, batch: dict, generator: torch.Generator) -> tuple[torch.Tensor, dict]:
        """``(loss, metrics)`` of one batch, drawing from ``generator``."""
        ...

    # -- step/epoch hooks --------------------------------------------------------

    def before_train_step(self) -> None:
        self.increment_step()

    def after_train_step(self) -> None:
        self._send_logs_at_step()

    def before_backward(self) -> None:
        pass

    def after_backward(self) -> None:
        # gradient clipping lives in the optimizer recipe (training/optimizer.py)
        pass

    def before_train_epoch(self) -> None:
        pass

    def after_train_epoch(self) -> None:
        self._send_logs_at_epoch()

    # -- saving / preview hooks ------------------------------------------------------

    def get_state_dict_to_save(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()

    def get_metadata_to_save(self) -> dict[str, str]:
        return {}

    def before_save_model(self) -> None:
        pass

    def after_save_model(self) -> None:
        pass

    def before_preview(self) -> None:
        pass

    def before_preview_step(self) -> None:
        pass

    @abstractmethod
    def preview_step(self, batch: dict, preview_index: int) -> Any:
        ...

    def after_preview_step(self) -> None:
        pass

    def after_preview(self) -> None:
        pass

    # -- logging ---------------------------------------------------------------------

    def print(self, *args, **kwargs) -> None:
        print(*args, **kwargs)

    def log(self, name: str, value, on_step: bool = True, on_epoch: bool = False) -> None:
        if isinstance(value, torch.Tensor):
            value = float(value.detach().float().mean())
        elif isinstance(value, np.ndarray):
            value = float(value.mean())
        if on_step:
            self._logs_at_step[name] = value
        if on_epoch:
            self._logs_at_epoch.setdefault(name, []).append(value)

    def _send_logs_at_step(self) -> None:
        self.trainer.log_dict(self._logs_at_step, step=self._current_step)
        self._logs_at_step = {}

    def _send_logs_at_epoch(self) -> None:
        for name, values in self._logs_at_epoch.items():
            if values and isinstance(values[0], (float, int)):
                self.trainer.log_dict(
                    {f"{name}_epoch": sum(values) / len(values)}, step=self._current_step
                )
            else:
                for i, value in enumerate(values):
                    self.trainer.log_dict({f"{name}_{i}_epoch": value}, step=self._current_step)
        self._logs_at_epoch = {}

    def increment_step(self) -> None:
        self._current_step += 1
