"""Inference-time timestep schedules (``vision_ft_tpu/modules/timestep/
scheduler.py`` counterpart): Flux's resolution-shifted schedule and the
plain linear one its ``generate()`` walks."""

from __future__ import annotations

import numpy as np

from .sampling import get_lin_function


def get_flux_schedule(
    num_steps: int,
    image_seq_len: int,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
    shift: bool = True,  # False for schnell
) -> list[float]:
    timesteps = np.linspace(1.0, 0.0, num_steps + 1)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        with np.errstate(divide="ignore"):
            timesteps = np.exp(mu) / (np.exp(mu) + (1.0 / timesteps - 1.0))
        timesteps[-1] = 0.0
    return timesteps.tolist()


def get_linear_schedule(num_steps: int, start: float = 1.0, end: float = 0.0) -> np.ndarray:
    return np.linspace(start, end, num_steps, dtype=np.float32)
