"""Lumina2 flow-match Euler scheduler
(``vision_ft_tpu/models/lumina2/scheduler.py`` counterpart): shift 6.0,
reversed timesteps (0 -> 1, t = 1 is the clean image), Euler step
x <- x + v * (sigma - sigma_next). The tables are the JAX package's numpy
float32 tables. The resolution-aware training sampler
(``sample_sigmoid_randn``) belongs to the train step and is not ported yet.
"""

from __future__ import annotations

import numpy as np


class Scheduler:
    shift: float = 6.0
    num_train_timesteps: int = 1000

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

    def step(self, latent, velocity_pred, sigma, next_sigma):
        return latent + velocity_pred * (sigma - next_sigma)
