"""Auto image-encoder backbones (``vision_ft_tpu/models/auto.py``
counterpart): timm or transformers vision models as frozen feature
extractors for the PFG and style-tokenizer projectors.

``AutoImageEncoder.__call__`` takes a normalized (B, 3, H, W) pixel batch
(numpy or a tensor) and returns the features, a tensor on the model's
device: (B, D) for ``pooler_output``, (B, S, D) for ``hidden_state``.
The timm and transformers packages load the models; where a package is
not installed, loading raises ``ImportError`` naming it. Any callable
with the same contract can stand in (the adapter models take
``image_encoder=``), such as the port's native SigLIP
(``models/vision_encoders/siglip.py``) behind an NCHW-to-NHWC adapter.
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import torch
from pydantic import BaseModel


class AbstractAutoModelConfig(BaseModel):
    type: str = "timm"
    model_name: str = ""
    config: dict = {}
    pretrained: bool = True

    feature_type: Literal["hidden_state", "pooler_output"] = "pooler_output"
    hidden_state_index: int = -1


def _require(package: str):
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(
            f"the {package} package is not installed; pass an image_encoder callable to the "
            "adapter model instead"
        ) from e


class TransformersModelConfig(AbstractAutoModelConfig):
    type: Literal["transformers"] = "transformers"

    def load_model(self):
        transformers = _require("transformers")
        if self.pretrained:
            return transformers.AutoModel.from_pretrained(self.model_name, **self.config)
        return transformers.AutoModel.from_config(
            transformers.AutoConfig.from_pretrained(self.model_name, **self.config)
        )


class TimmModelConfig(AbstractAutoModelConfig):
    type: Literal["timm"] = "timm"
    model_name: str = "hf_hub:timm/vit_base_patch16_siglip_384.v2_webli"

    def load_model(self):
        timm = _require("timm")
        model = timm.create_model(self.model_name, pretrained=self.pretrained, **self.config)
        model.reset_classifier(0)
        return model


AutoModelConfig = Union[TransformersModelConfig, TimmModelConfig]


class AutoImageEncoder:
    """A frozen feature extractor, loaded on first use (or at
    construction with ``lazy=False``) onto ``device``: the card unless the
    caller names another."""

    def __init__(self, config: AutoModelConfig, lazy: bool = True,
                 device: Optional[Union[torch.device, str]] = None):
        self.config = config
        self.device = torch.device("cuda" if device is None else device)
        self.model = None
        if not lazy:
            self._load_model()

    def _load_model(self) -> None:
        self.model = self.config.load_model().eval().to(self.device)
        self.model.requires_grad_(False)

    def __call__(self, pixel_values) -> torch.Tensor:
        if self.model is None:
            self._load_model()
        pixel_values = torch.as_tensor(pixel_values).to(self.device)
        with torch.no_grad():
            if isinstance(self.config, TransformersModelConfig):
                outputs = self.model(pixel_values, output_hidden_states=True)
                if self.config.feature_type == "hidden_state":
                    return outputs.hidden_states[self.config.hidden_state_index]
                return outputs.pooler_output
            if self.config.feature_type == "hidden_state":
                return self.model.forward_features(pixel_values)
            return self.model(pixel_values)

    def state_dict(self):
        return {} if self.model is None else self.model.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        if self.model is None:
            self._load_model()
        self.model.load_state_dict(state_dict, strict=strict)
