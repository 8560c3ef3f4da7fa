"""AuraFlow flow-match Euler scheduler
(``vision_ft_tpu/models/auraflow/scheduler.py`` counterpart): diffusers'
``FlowMatchEulerDiscreteScheduler(shift=1.73)`` recipe, in float64 numpy:

  init:   sigmas0 = shift(t / 1000) for t in 1000..1
  set:    timesteps = linspace(1000 sigma_max, 1000 sigma_min, n)
          sigmas = shift(timesteps / 1000), then 0
  step:   x <- x + (sigma_next - sigma) * velocity

where shift(s) = shift s / (1 + (shift - 1) s).
"""

from __future__ import annotations

import numpy as np


class Scheduler:
    order = 1

    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.73) -> None:
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift
        base = np.arange(num_train_timesteps, 0, -1, dtype=np.float64) / num_train_timesteps
        shifted = self._shift(base)
        self.sigma_max = float(shifted[0])
        self.sigma_min = float(shifted[-1])
        self.timesteps: np.ndarray = shifted * num_train_timesteps
        self.sigmas: np.ndarray = np.concatenate([shifted, [0.0]])

    def _shift(self, sigmas: np.ndarray) -> np.ndarray:
        return self.shift * sigmas / (1 + (self.shift - 1) * sigmas)

    def schedule_tables(self, num_inference_steps: int) -> tuple[np.ndarray, np.ndarray]:
        """(timesteps, sigmas) for a step count, without changing the
        scheduler's state."""
        timesteps = np.linspace(
            self.sigma_max * self.num_train_timesteps,
            self.sigma_min * self.num_train_timesteps,
            num_inference_steps,
            dtype=np.float64,
        )
        sigmas = self._shift(timesteps / self.num_train_timesteps)
        return sigmas * self.num_train_timesteps, np.concatenate([sigmas, [0.0]])

    def set_timesteps(self, num_inference_steps: int) -> None:
        self.timesteps, self.sigmas = self.schedule_tables(num_inference_steps)

    def retrieve_timesteps(
        self, num_inference_steps: int, device=None, sigmas=None
    ) -> tuple[np.ndarray, int]:
        if sigmas is not None:
            sigmas = np.asarray(sigmas, np.float64)
            self.timesteps = sigmas * self.num_train_timesteps
            self.sigmas = np.concatenate([sigmas, [0.0]])
            return self.timesteps, len(self.timesteps)
        self.set_timesteps(num_inference_steps)
        return self.timesteps, num_inference_steps

    def step(self, model_output, timestep_index: int, sample):
        """The Euler step by index."""
        sigma = float(self.sigmas[timestep_index])
        sigma_next = float(self.sigmas[timestep_index + 1])
        return sample + (sigma_next - sigma) * model_output
