"""Euler-discrete (+ancestral) scheduler for SDXL
(``vision_ft_tpu/models/sdxl/scheduler.py`` counterpart).

The sigma tables are the JAX package's numpy float32 tables. The per-step
scalars (input scale, sigma_up, sigma_down) are float32 numpy values, as
the JAX package computes them on device in float32; the updates run on
tensors.
"""

from __future__ import annotations

import numpy as np
import torch


class Scheduler:
    beta_start: float = 0.00085
    beta_end: float = 0.012
    num_train_timesteps: int = 1000
    steps_offset: int = 1

    def get_timesteps(self, num_inference_steps: int) -> np.ndarray:
        step_ratio = self.num_train_timesteps // num_inference_steps
        timesteps = (
            np.arange(self.num_train_timesteps, 0, -step_ratio).round().astype(np.float32) - 1
        )
        return timesteps + self.steps_offset

    def get_sigmas(self, timesteps: np.ndarray) -> np.ndarray:
        betas = (
            np.linspace(
                self.beta_start**0.5, self.beta_end**0.5, self.num_train_timesteps,
                dtype=np.float32,
            )
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        sigmas = np.sqrt((1 - alphas_cumprod) / alphas_cumprod)
        sigmas = np.interp(timesteps, np.arange(0, len(sigmas)), sigmas)
        return np.concatenate([sigmas, [0.0]]).astype(np.float32)

    def get_max_noise_sigma(self, sigmas: np.ndarray) -> float:
        return float(np.sqrt(sigmas.max() ** 2 + 1))

    def scale_model_input(self, sample: torch.Tensor, current_sigma) -> torch.Tensor:
        sigma = np.float32(current_sigma)
        return sample / float(np.sqrt(sigma**2 + np.float32(1)))

    def ancestral_step(
        self,
        latent: torch.Tensor,
        noise_pred: torch.Tensor,
        sigma,
        next_sigma,
        noise: torch.Tensor,
    ) -> torch.Tensor:
        """Euler-ancestral update; ``noise`` is passed in explicitly."""
        sigma, next_sigma = np.float32(sigma), np.float32(next_sigma)
        sigma_up = np.sqrt(next_sigma**2 * (sigma**2 - next_sigma**2) / sigma**2)
        sigma_down = np.sqrt(next_sigma**2 - sigma_up**2)
        dt = sigma_down - sigma
        return latent + noise_pred * float(dt) + noise * float(sigma_up)

