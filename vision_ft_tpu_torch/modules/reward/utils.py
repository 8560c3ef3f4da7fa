"""Reward model protocol (``vision_ft_tpu/modules/reward/utils.py``
counterpart)."""

from __future__ import annotations

from abc import ABC, abstractmethod

import torch
from pydantic import BaseModel


class RewardModelMixin(ABC):
    """A reward model scores (images, prompts).

    - ``__call__(images, prompts)``: PIL images and prompt strings ->
      per-image scores or probabilities;
    - ``score(images, prompt_ids)``: NHWC [-1, 1] image tensors and token
      ids -> per-sample scores, differentiable with respect to the images
      (what the DRaFT+ loss needs).
    """

    @abstractmethod
    def __call__(self, images, prompts) -> torch.Tensor:
        ...

    def score(self, images: torch.Tensor, prompt_ids) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} does not support the differentiable path")


class RewardModelConfig(BaseModel, ABC):
    type: str

    @abstractmethod
    def load_model(self, device=None) -> RewardModelMixin:
        ...
