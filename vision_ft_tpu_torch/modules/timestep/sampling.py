"""Train-time timestep samplers (``vision_ft_tpu/modules/timestep/
sampling.py`` counterpart).

All samplers take an explicit ``torch.Generator`` (in place of the JAX
PRNG key) and a latents *shape* (NHWC) and return a (B,) tensor on the
generator's device. The transforms are the JAX package's; the random bits
are PyTorch's, so the same seed gives other draws.
"""

from __future__ import annotations

import math
from typing import Callable, Literal, Sequence

import numpy as np
import torch

TimestepSamplingType = Literal[
    "shift_sigmoid", "flux_shift", "sigmoid", "uniform", "scale_shift_sigmoid"
]


def _randn(generator: torch.Generator, batch_size: int) -> torch.Tensor:
    return torch.randn((batch_size,), generator=generator, device=generator.device)


# -- flow-match (continuous t in [0,1]) --------------------------------------


def get_lin_function(
    x1: float = 256, y1: float = 0.5, x2: float = 4096, y2: float = 1.15
) -> Callable[[float], float]:
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0) ** sigma)


def time_shift_linear(mu: float, t: torch.Tensor) -> torch.Tensor:
    """CogView4's linear shift."""
    return mu / (mu + (1.0 / t - 1.0))


def sigmoid_randn(
    generator: torch.Generator, latents_shape: Sequence[int], sigmoid_scale: float = 1.0
) -> torch.Tensor:
    return torch.sigmoid(_randn(generator, latents_shape[0]) * sigmoid_scale)


def shift_sigmoid_randn(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    discrete_flow_shift: float = 3.1825,
    sigmoid_scale: float = 1.0,
) -> torch.Tensor:
    t = sigmoid_randn(generator, latents_shape, sigmoid_scale)
    s = discrete_flow_shift
    return (t * s) / (1.0 + (s - 1.0) * t)


def flux_shift_randn(
    generator: torch.Generator, latents_shape: Sequence[int], sigmoid_scale: float = 1.0
) -> torch.Tensor:
    """Resolution-aware mu shift. NHWC shape."""
    _, height, width, _ = latents_shape
    t = sigmoid_randn(generator, latents_shape, sigmoid_scale)
    mu = get_lin_function(y1=0.5, y2=1.15)((height // 2) * (width // 2))
    return time_shift(mu, 1.0, t)


def scale_shift_sigmoid_randn(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    std: float = 0.8,
    mean: float = -0.8,
    **_: object,
) -> torch.Tensor:
    return torch.sigmoid(_randn(generator, latents_shape[0]) * std + mean)


def uniform_rand(generator: torch.Generator, latents_shape: Sequence[int]) -> torch.Tensor:
    return torch.rand((latents_shape[0],), generator=generator, device=generator.device)


def shift_uniform_rand(
    generator: torch.Generator, latents_shape: Sequence[int], shift: float = 6.0
) -> torch.Tensor:
    t = uniform_rand(generator, latents_shape)
    return (t * shift) / (1.0 + (shift - 1.0) * t)


def _create_fraction(denominators: Sequence[int]) -> np.ndarray:
    unique = {i / d for d in denominators for i in range(0, d + 1)}
    return np.array(sorted(unique), dtype=np.float32)


def fraction_uniform_rand(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    divisible: Sequence[int] = tuple(range(20, 30)),
) -> torch.Tensor:
    """Sample t only from {i/d} grids."""
    if len(divisible) == 0:
        raise ValueError("divisible must not be empty")
    fractions = torch.from_numpy(_create_fraction(divisible)).to(generator.device)
    idx = torch.randint(
        0, fractions.shape[0], (latents_shape[0],), generator=generator, device=generator.device
    )
    return fractions[idx]


def shift_fraction_uniform_rand(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    shift: float = 6.0,
    divisible: Sequence[int] = tuple(range(20, 30)),
) -> torch.Tensor:
    t = fraction_uniform_rand(generator, latents_shape, divisible)
    return (t * shift) / (1.0 + (shift - 1.0) * t)


def sample_timestep(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    sampling_type: TimestepSamplingType = "sigmoid",
    **kwargs: object,
) -> torch.Tensor:
    if sampling_type == "shift_sigmoid":
        return shift_sigmoid_randn(generator, latents_shape, **kwargs)
    if sampling_type == "flux_shift":
        return flux_shift_randn(generator, latents_shape, **kwargs)
    if sampling_type == "sigmoid":
        return sigmoid_randn(generator, latents_shape, **kwargs)
    if sampling_type == "uniform":
        return uniform_rand(generator, latents_shape)
    if sampling_type == "scale_shift_sigmoid":
        return scale_shift_sigmoid_randn(generator, latents_shape, **kwargs)
    raise ValueError(f"Invalid sampling type: {sampling_type}")


# -- diffusion (integer t) ---------------------------------------------------


def uniform_randint(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    min_timesteps: int = 0,
    max_timesteps: int = 1000,
) -> torch.Tensor:
    return torch.randint(
        min_timesteps, max_timesteps, (latents_shape[0],),
        generator=generator, device=generator.device, dtype=torch.int32,
    )


def gaussian_randint(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    min_timesteps: int = 0,
    max_timesteps: int = 1000,
    mean: float = 500,
    std: float = 500,
) -> torch.Tensor:
    """Categorical over ints with Gaussian weights."""
    idx = torch.arange(
        min_timesteps, max_timesteps + 1, dtype=torch.float32, device=generator.device
    )
    weights = torch.softmax(-0.5 * torch.square((idx - mean) / std), dim=0)
    draw = torch.multinomial(weights, latents_shape[0], replacement=True, generator=generator)
    return (draw + min_timesteps).to(torch.int32)


def sigmoid_randint(
    generator: torch.Generator,
    latents_shape: Sequence[int],
    min_timesteps: int = 0,
    max_timesteps: int = 1000,
    sigmoid_scale: float = 1.0,
) -> torch.Tensor:
    t = sigmoid_randn(generator, latents_shape, sigmoid_scale)
    t = t * (max_timesteps - min_timesteps) + min_timesteps
    return torch.round(t).to(torch.int32)
