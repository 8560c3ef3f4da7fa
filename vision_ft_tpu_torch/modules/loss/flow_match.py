"""Rectified-flow / flow-matching training losses
(``vision_ft_tpu/modules/loss/flow_match.py`` counterpart).

Timestep convention as in the JAX package: t = 1 is pure noise and t = 0
is clean data in :func:`prepare_noised_latents`; the "scaled" variant flips
that with ``clean_at_zero``. Noise is drawn from an explicit
``torch.Generator`` (in place of the JAX PRNG key) in fp32, or given; the
loss is computed in fp32.
"""

from __future__ import annotations

from typing import Literal, NamedTuple, Optional

import torch

ModelPredictionType = Literal["noise", "velocity", "image"]  # eps, v, x0


class NoisedLatents(NamedTuple):
    noisy_latents: torch.Tensor
    random_noise: torch.Tensor


def _expand(timestep: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return timestep.reshape((like.shape[0],) + (1,) * (like.ndim - 1)).float()


def _noise(
    generator: Optional[torch.Generator], latents: torch.Tensor, noise: Optional[torch.Tensor]
) -> torch.Tensor:
    """fp32 unit normal noise of the latents' shape: ``noise`` as given, or
    drawn from ``generator``."""
    if noise is None:
        if generator is None:
            raise ValueError("need a generator or the noise")
        noise = torch.randn(
            latents.shape, generator=generator, dtype=torch.float32, device=generator.device
        )
    return noise.float().to(latents.device)


def prepare_noised_latents(
    generator: Optional[torch.Generator],
    latents: torch.Tensor,
    timestep: torch.Tensor,
    max_sigma: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> NoisedLatents:
    """x_t = (1-t) x_0 + t * noise, noise ~ N(0, max_sigma^2); both results
    in the latents' dtype."""
    t = _expand(timestep, latents)
    noise = _noise(generator, latents, noise) * max_sigma
    noisy = (1.0 - t) * latents.float() + t * noise
    return NoisedLatents(noisy.to(latents.dtype), noise.to(latents.dtype))


def prepare_scaled_noised_latents(
    generator: Optional[torch.Generator],
    latents: torch.Tensor,
    timestep: torch.Tensor,
    noise_scale: float = 1.0,
    clean_at_zero: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> NoisedLatents:
    t = _expand(timestep, latents)
    noise = _noise(generator, latents, noise) * noise_scale
    x0 = latents.float()
    if clean_at_zero:
        noisy = (1.0 - t) * x0 + t * noise
    else:
        noisy = t * x0 + (1.0 - t) * noise
    return NoisedLatents(noisy.to(latents.dtype), noise.to(latents.dtype))


def get_flow_match_target_velocity(
    latents: torch.Tensor, random_noise: torch.Tensor
) -> torch.Tensor:
    return random_noise - latents


def loss_with_predicted_velocity(
    latents: torch.Tensor,
    random_noise: torch.Tensor,
    predicted_velocity: torch.Tensor,
) -> torch.Tensor:
    """Mean MSE vs. the target velocity (noise - latents), in fp32."""
    target = random_noise.float() - latents.float()
    diff = predicted_velocity.float() - target
    return torch.mean(torch.square(diff))


def convert_x0_to_velocity(
    x0: torch.Tensor,
    noisy_latents: torch.Tensor,
    timestep: torch.Tensor,
    eps: float = 1e-5,
    clean_at_zero: bool = False,
) -> torch.Tensor:
    """x0-prediction -> the velocity it implies."""
    t = _expand(timestep, x0)
    x0f = x0.float()
    xt = noisy_latents.float()
    if clean_at_zero:
        velocity = (xt - x0f) / torch.clamp(t, min=eps)
    else:
        velocity = (x0f - xt) / torch.clamp(1.0 - t, min=eps)
    return velocity.to(x0.dtype)
