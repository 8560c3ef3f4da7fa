"""PickScore reward model (``vision_ft_tpu/modules/reward/pickscore.py``
counterpart): the laion CLIP-H text tower (``models/text_encoders/
clip.py``) and vision tower (``models/vision_encoders/clip_vision.py``),
so ``score(images, prompt_ids)`` is differentiable with respect to the
images and DRaFT+ can train on it.

The module's state-dict keys are those of the Hugging Face
``yuvalkirstain/PickScore_v1`` checkpoint (``text_model.*``,
``text_projection.weight``, ``vision_model.*``, ``visual_projection.weight``,
``logit_scale``). ``from_pretrained`` reads a local directory in that
layout: ``model.safetensors`` (its ``position_ids`` dropped) and the CLIP
tokenizer's ``vocab.json`` / ``merges.txt``; there is no hub download.
The preprocessed pixels enter the vision tower in the model's dtype.
"""

from __future__ import annotations

import os
from typing import Literal, Optional

import numpy as np
import torch
from torch import nn

from ...models.text_encoders.clip import CLIPTextConfig, CLIPTextModelWithProjection
from ...models.text_encoders.tokenizer import CLIPTokenizer
from ...models.vision_encoders.clip_vision import (
    PICKSCORE_VISION_CONFIG,
    CLIPVisionConfig,
    CLIPVisionModelWithProjection,
    clip_preprocess,
)
from ...nn import init_parameters_, load_flat_params
from ...utils import safetensors as st
from ...utils import tensor as tensor_utils
from .utils import RewardModelConfig, RewardModelMixin

# PickScore_v1 text tower (laion CLIP-H)
PICKSCORE_TEXT_CONFIG = CLIPTextConfig(
    vocab_size=49408,
    hidden_size=1024,
    intermediate_size=4096,
    num_hidden_layers=24,
    num_attention_heads=16,
    hidden_act="gelu",
    projection_dim=1024,
)


class PickScoreConfig(RewardModelConfig):
    type: Literal["pickscore"] = "pickscore"

    model_id: str = "yuvalkirstain/PickScore_v1"

    def load_model(self, device=None) -> "PickScoreRewardModel":
        return PickScoreRewardModel.from_pretrained(self.model_id, device=device)


class PickScoreRewardModel(nn.Module, RewardModelMixin):
    """Built on the meta device; :meth:`init_params` (seeded weights) or
    :meth:`load_state_dict_flat` materializes it."""

    def __init__(self, tokenizer=None, text_config: Optional[CLIPTextConfig] = None,
                 vision_config: Optional[CLIPVisionConfig] = None):
        super().__init__()
        vision_config = vision_config or PICKSCORE_VISION_CONFIG
        with torch.device("meta"):
            text = CLIPTextModelWithProjection(text_config or PICKSCORE_TEXT_CONFIG)
            vision = CLIPVisionModelWithProjection(vision_config)
            self.logit_scale = nn.Parameter(torch.empty(()))
        # the towers' parts, registered here under the checkpoint's keys
        self.text_model = text.text_model
        self.text_projection = text.text_projection
        self.vision_model = vision.vision_model
        self.visual_projection = vision.visual_projection
        self._towers = (text, vision)
        self.tokenizer = tokenizer
        self.image_size = vision_config.image_size

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.logit_scale.fill_(float(np.log(100.0)))

    def init_params(self, generator: torch.Generator, dtype: torch.dtype = torch.float32,
                    device=None) -> "PickScoreRewardModel":
        self.to(dtype=dtype).to_empty(device=generator.device if device is None else device)
        init_parameters_(self, generator)
        return self.eval().requires_grad_(False)

    def load_state_dict_flat(self, flat, dtype: Optional[torch.dtype] = None,
                             device=None) -> "PickScoreRewardModel":
        """The checkpoint's flat tensors (``position_ids`` dropped), in
        ``dtype`` (default: the checkpoint's) onto ``device`` (default: the
        card)."""
        flat = {k: v for k, v in flat.items() if "position_ids" not in k}
        if dtype is None:
            dtype = torch.as_tensor(next(iter(flat.values()))).dtype
        self.to(dtype=dtype)
        load_flat_params(self, flat, meta_device=torch.device("cuda" if device is None else device))
        return self.eval().requires_grad_(False)

    @classmethod
    def from_pretrained(cls, model_id: str, device=None, dtype: Optional[torch.dtype] = None,
                        **configs) -> "PickScoreRewardModel":
        """``configs``: ``text_config`` / ``vision_config`` where the
        checkpoint is not PickScore_v1's size."""
        if not os.path.isdir(model_id):
            raise FileNotFoundError(
                f"{model_id!r} is not a local directory: PickScore loads from a directory in the "
                "Hugging Face layout (model.safetensors, vocab.json, merges.txt), not from the hub"
            )
        tokenizer = CLIPTokenizer.from_pretrained_dir(model_id)
        flat = st.load_file(os.path.join(model_id, "model.safetensors"))
        return cls(tokenizer=tokenizer, **configs).load_state_dict_flat(flat, dtype=dtype, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.logit_scale.dtype

    # -- embeddings -------------------------------------------------------------------

    def text_embeds(self, input_ids: torch.Tensor) -> torch.Tensor:
        _, _, embeds = self._towers[0](input_ids)
        embeds = embeds.float()
        return embeds / torch.linalg.vector_norm(embeds, dim=-1, keepdim=True)

    def image_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """images: NHWC float in [-1, 1], differentiable."""
        pixels = clip_preprocess(images, self.image_size).to(self.dtype)
        _, embeds = self._towers[1](pixels)
        embeds = embeds.float()
        return embeds / torch.linalg.vector_norm(embeds, dim=-1, keepdim=True)

    # -- scoring ----------------------------------------------------------------------

    def score(self, images: torch.Tensor, prompt_ids) -> torch.Tensor:
        """Per-sample PickScore exp(logit_scale) * <text_i, image_i>."""
        prompt_ids = torch.as_tensor(prompt_ids, device=images.device)
        t = self.text_embeds(prompt_ids)
        v = self.image_embeds(images)
        return self.logit_scale.float().exp() * (t * v).sum(dim=-1)

    def __call__(self, images, prompts) -> torch.Tensor:
        """PIL images and prompts -> softmax over the images of their
        scores against the first prompt."""
        from PIL import Image

        if isinstance(images, Image.Image):
            images = [images]
        if isinstance(prompts, str):
            prompts = [prompts]
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured for PickScoreRewardModel")
        device = self.logit_scale.device
        with torch.no_grad():
            image_tensor = tensor_utils.images_to_tensor(list(images)).to(device)
            ids = torch.from_numpy(self.tokenizer(prompts, max_length=77)).long().to(device)
            t = self.text_embeds(ids)
            v = self.image_embeds(image_tensor)
            scores = self.logit_scale.float().exp() * (t @ v.T)[0]
        return torch.softmax(scores, dim=-1)
