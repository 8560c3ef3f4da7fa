"""Safetensors saving callback (``vision_ft_tpu/saving/safetensors.py`` counterpart)."""

from __future__ import annotations

from typing import Any, Optional

from ..utils import safetensors as st
from .util import ModelSavingCallback, ModelSavingCallbackConfig


class SafetensorsSavingCallbackConfig(ModelSavingCallbackConfig):
    type: str = "safetensors"


class SafetensorsSavingCallback(ModelSavingCallback):
    def save_state_dict(
        self,
        state_dict: dict[str, Any],
        epoch: int,
        steps: int,
        metadata: Optional[dict] = None,
    ):
        file_name = self.format_template(name=self.name, epoch=epoch, steps=steps)
        save_path = self.save_dir / file_name
        save_path.parent.mkdir(parents=True, exist_ok=True)
        st.save_file(state_dict, str(save_path), metadata=metadata)
        return save_path
