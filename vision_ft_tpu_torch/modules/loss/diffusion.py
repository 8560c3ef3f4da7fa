"""DDPM epsilon-prediction training loss (SDXL)
(``vision_ft_tpu/modules/loss/diffusion.py`` counterpart).

An explicit ``torch.Generator`` takes the place of the JAX PRNG key;
latents are NHWC; the beta / alpha-cumprod table is computed in fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NoisedLatents(NamedTuple):
    noisy_latents: torch.Tensor
    random_noise: torch.Tensor


def get_alphas_cumprod(
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    num_train_timesteps: int = 1000,
    device=None,
) -> torch.Tensor:
    """SD-style scaled-linear schedule: linspace on sqrt(beta), squared."""
    betas = (
        torch.linspace(
            beta_start**0.5, beta_end**0.5, num_train_timesteps,
            dtype=torch.float32, device=device,
        )
        ** 2
    )
    return torch.cumprod(1.0 - betas, dim=0)


def add_noise(
    latents: torch.Tensor,
    random_noise: torch.Tensor,
    timestep: torch.Tensor,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    num_train_timesteps: int = 1000,
) -> NoisedLatents:
    """q(x_t | x_0) for a given fp32 noise draw: sqrt(a) x_0 + sqrt(1-a)
    noise in fp32, both results in the latents' dtype."""
    alphas_cumprod = get_alphas_cumprod(
        beta_start, beta_end, num_train_timesteps, device=latents.device
    )
    a = alphas_cumprod[timestep.long()].reshape((latents.shape[0],) + (1,) * (latents.ndim - 1))
    noisy = torch.sqrt(a) * latents.float() + torch.sqrt(1.0 - a) * random_noise.float()
    return NoisedLatents(noisy.to(latents.dtype), random_noise.to(latents.dtype))


def prepare_noised_latents(
    generator: torch.Generator,
    latents: torch.Tensor,
    timestep: torch.Tensor,
    max_sigma: float = 1.0,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    num_train_timesteps: int = 1000,
) -> NoisedLatents:
    """Forward-process q(x_t | x_0) sample.

    ``timestep``: int tensor (B,), 0 <= t < num_train_timesteps.
    """
    random_noise = (
        torch.randn(
            latents.shape, generator=generator, dtype=torch.float32, device=generator.device
        ).to(latents.device)
        * max_sigma
    )
    return add_noise(latents, random_noise, timestep, beta_start, beta_end, num_train_timesteps)


def loss_with_predicted_noise(
    latents: torch.Tensor,  # unused; kept for the JAX signature
    random_noise: torch.Tensor,
    predicted_noise: torch.Tensor,
) -> torch.Tensor:
    """Mean MSE vs. the injected noise, in fp32."""
    diff = predicted_noise.float() - random_noise.float()
    return torch.mean(torch.square(diff))


def min_snr_weighted_loss(
    latents: torch.Tensor,  # unused; kept for signature symmetry
    random_noise: torch.Tensor,
    predicted_noise: torch.Tensor,
    timestep: torch.Tensor,
    gamma: float = 5.0,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    num_train_timesteps: int = 1000,
) -> torch.Tensor:
    """Min-SNR-gamma weighted epsilon MSE (Hang et al. 2023,
    arXiv:2303.09556). Per-sample weight = min(SNR(t), gamma) / SNR(t) with
    SNR(t) = a / (1 - a). Reduces to the unweighted loss as gamma -> inf."""
    alphas_cumprod = get_alphas_cumprod(
        beta_start, beta_end, num_train_timesteps, device=predicted_noise.device
    )
    a = alphas_cumprod[timestep.long()]  # (B,)
    snr = a / (1.0 - a)
    weight = torch.clamp(snr, max=gamma) / snr  # (B,)
    diff = predicted_noise.float() - random_noise.float()
    per_sample = torch.square(diff).reshape(diff.shape[0], -1).mean(dim=1)
    return torch.mean(weight * per_sample)
