"""Hugging Face Hub saving callback (``vision_ft_tpu/saving/hf_hub.py``
counterpart): save the safetensors file locally, then upload it to a hub
repo through ``api.upload_file``. ``api`` is any object with that method;
without one the callback makes ``huggingface_hub.HfApi()``, and raises
``ImportError`` naming the package where it is not installed."""

from __future__ import annotations

from typing import Any, Optional

from .safetensors import SafetensorsSavingCallback, SafetensorsSavingCallbackConfig


class HFHubSavingCallbackConfig(SafetensorsSavingCallbackConfig):
    type: str = "hf_hub"

    hub_id: str
    dir_in_repo: str
    repo_type: str = "model"


class HFHubSavingCallback(SafetensorsSavingCallback):
    def __init__(
        self,
        name: str,
        save_dir,
        hub_id: str,
        dir_in_repo: str,
        repo_type: str = "model",
        save_name_template: Optional[str] = None,
        api: Any = None,
    ) -> None:
        super().__init__(name, save_dir, save_name_template)
        self.hub_id = hub_id
        self.dir_in_repo = dir_in_repo
        self.repo_type = repo_type
        if api is None:
            try:
                from huggingface_hub import HfApi
            except ImportError as error:
                raise ImportError(
                    "the Hugging Face Hub saving callback needs the huggingface_hub package "
                    "(or an api= object with upload_file)"
                ) from error
            api = HfApi()
        self.api = api

    def save_state_dict(
        self,
        state_dict: dict[str, Any],
        epoch: int,
        steps: int,
        metadata: Optional[dict] = None,
    ):
        save_path = super().save_state_dict(state_dict, epoch, steps, metadata)
        self.api.upload_file(
            path_or_fileobj=save_path,
            path_in_repo=f"{self.dir_in_repo}/{save_path.name}",
            repo_id=self.hub_id,
            repo_type=self.repo_type,
        )
        return save_path
