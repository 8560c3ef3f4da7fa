"""Wan flow-match Euler scheduler (``vision_ft_tpu/models/wan/scheduler.py``
counterpart): shift 5.0, ``x <- x + v (next_sigma - sigma)``. The tables
are fp32 numpy, as in the JAX package."""

from __future__ import annotations

import numpy as np


class Scheduler:
    shift: float = 5.0
    num_train_timesteps: int = 1000

    def _calculate_sigma(self, num_inference_steps: int) -> np.ndarray:
        return np.linspace(1.0, 1 / num_inference_steps, num_inference_steps, dtype=np.float32)

    def get_timesteps(self, num_inference_steps: int) -> np.ndarray:
        sigmas = self._calculate_sigma(num_inference_steps)
        timesteps = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        return timesteps * self.num_train_timesteps

    def get_sigmas(self, num_inference_steps: int) -> np.ndarray:
        sigmas = self._calculate_sigma(num_inference_steps)
        sigmas = self.shift * sigmas / (1 + (self.shift - 1) * sigmas)
        return np.concatenate([sigmas, [0]]).astype(np.float32)

    def step(self, latent, velocity_pred, sigma, next_sigma):
        return latent + velocity_pred * (next_sigma - sigma)
