"""Lumina2 flow-match Euler scheduler
(``vision_ft_tpu/models/lumina2/scheduler.py`` counterpart): shift 6.0,
reversed timesteps (0 -> 1, t = 1 is the clean image), Euler step
x <- x + v * (sigma - sigma_next), and the resolution-aware lognorm
training sampler. The tables are the JAX package's numpy float32 tables.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ...modules.timestep.sampling import get_lin_function, sigmoid_randn


class Scheduler:
    shift: float = 6.0
    num_train_timesteps: int = 1000

    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096

    def _calculate_sigma(self, num_inference_steps: int) -> np.ndarray:
        return np.linspace(1.0, 1 / num_inference_steps, num_inference_steps, dtype=np.float32)

    def get_timesteps(self, num_inference_steps: int) -> np.ndarray:
        sigmas = self._calculate_sigma(num_inference_steps)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        return 1 - sigmas  # 0.0 -> 1.0

    def get_sigmas(self, num_inference_steps: int) -> np.ndarray:
        sigmas = self._calculate_sigma(num_inference_steps)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        return np.concatenate([sigmas, [0]]).astype(np.float32)

    def sample_sigmoid_randn(
        self,
        generator: torch.Generator,
        latents_shape: Sequence[int],
        patch_size: int = 2,
        sigma: float = 1.0,
    ) -> torch.Tensor:
        """Resolution-aware lognorm timestep sampling, (B,) on the
        generator's device; NHWC latents shape."""
        _, height, width, _ = latents_shape
        timesteps = sigmoid_randn(generator, latents_shape)
        seq_len = (height // patch_size) * (width // patch_size)
        mu = get_lin_function(
            x1=self.base_image_seq_len, y1=self.base_shift,
            x2=self.max_image_seq_len, y2=self.max_shift,
        )(seq_len)
        timesteps = 1 - timesteps
        timesteps = math.exp(mu) / (math.exp(mu) + (1 / timesteps - 1) ** sigma)
        return 1 - timesteps

    def step(self, latent, velocity_pred, sigma, next_sigma):
        return latent + velocity_pred * (sigma - next_sigma)
