"""Preview-generation args dataset (``vision_ft_tpu/dataset/preview/text_to_image.py``
counterpart):
a YAML/JSON list of generation requests -> list of dicts."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from pydantic import BaseModel

from ..util import DatasetConfig


class T2IPreviewArgs(BaseModel):
    prompt: str
    negative_prompt: Optional[str] = ""
    height: int = 1024
    width: int = 1024
    cfg_scale: float = 5.0
    num_steps: int = 20
    seed: int = 0
    extra: dict = {}


class TextToImagePreviewConfig(DatasetConfig):
    path: str

    def get_preview_args(self) -> list[T2IPreviewArgs]:
        path = Path(self.path)
        assert path.exists()
        extension = path.suffix.lower()
        if extension in (".yaml", ".yml"):
            import yaml

            with open(path) as f:
                config = yaml.safe_load(f)
        elif extension == ".json":
            with open(path) as f:
                config = json.load(f)
        else:
            raise ValueError(f"Unknown extension: {extension}")
        return [T2IPreviewArgs.model_validate(item) for item in config]

    def get_dataset(self) -> list[dict]:
        return [args.model_dump() for args in self.get_preview_args()]
