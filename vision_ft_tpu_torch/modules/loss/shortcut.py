"""Shortcut-model self-consistency loss pieces (``vision_ft_tpu/modules/
loss/shortcut.py`` counterpart; One-Step Diffusion via Shortcut Models,
arXiv:2410.12557).

As in the JAX package: the inference-step exponents are drawn from a
sqrt-weighted distribution over [min_pow, max_pow), so exponent 0 has
weight 0 and is never drawn; the departure timestep is
``(floor(u * steps) + 1) / steps`` on a uniform u (the distribution of
``randint(1, steps + 1) / steps``); both half-duration predictions are
multiplied by ``cfg_scale``. Draws come from a ``torch.Generator``: the
exponents, then u. The targets are made without gradients.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class ShortcutDuration(NamedTuple):
    inference_steps: torch.Tensor
    shortcut_exponent: torch.Tensor
    shortcut_duration: torch.Tensor
    departure_timesteps: torch.Tensor


def sample_weighted_inference_step_exponent(
    generator: torch.Generator, batch_size: int, min_pow: int = 0, max_pow: int = 7
) -> torch.Tensor:
    exponents = torch.arange(min_pow, max_pow, device=generator.device)
    weights = exponents.float().sqrt()
    idx = torch.multinomial(weights / weights.sum(), batch_size, replacement=True,
                            generator=generator)
    return exponents[idx]


def shortcut_duration_from(exponent: torch.Tensor, u: torch.Tensor) -> ShortcutDuration:
    """The durations of given exponents and uniform draws ``u`` in [0, 1)."""
    inference_steps = torch.pow(2.0, exponent.float())
    departure = (torch.floor(u.float() * inference_steps) + 1.0) / inference_steps
    return ShortcutDuration(
        inference_steps=inference_steps,
        shortcut_exponent=exponent,
        shortcut_duration=1.0 / inference_steps,
        departure_timesteps=departure,
    )


def prepare_random_shortcut_durations(
    generator: torch.Generator, batch_size: int, min_pow: int = 0, max_pow: int = 7
) -> ShortcutDuration:
    exponent = sample_weighted_inference_step_exponent(generator, batch_size, min_pow, max_pow)
    u = torch.rand((batch_size,), generator=generator, device=generator.device)
    return shortcut_duration_from(exponent, u)


class ShortcutTargets(NamedTuple):
    first_shortcut: torch.Tensor
    second_shortcut: torch.Tensor


@torch.no_grad()
def prepare_self_consistency_targets(
    denoise: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    latents: torch.Tensor,  # noisy latents, NHWC
    departure_timesteps: torch.Tensor,
    double_shortcut_duration: torch.Tensor,
    cfg_scale: float = 1.0,
) -> ShortcutTargets:
    """Two half-duration predictions whose mean is the self-consistency
    target. ``denoise(latents, t, duration)`` is the caller's denoiser."""
    half = double_shortcut_duration / 2.0
    first = denoise(latents, departure_timesteps, half) * cfg_scale
    pseudo_midpoint = latents - first * half[:, None, None, None].to(latents.dtype)
    second = denoise(pseudo_midpoint, departure_timesteps - half, half) * cfg_scale
    return ShortcutTargets(first_shortcut=first, second_shortcut=second)


def get_shortcut_target_velocity(
    first_shortcut: torch.Tensor, second_shortcut: torch.Tensor
) -> torch.Tensor:
    return (first_shortcut + second_shortcut) / 2.0


def loss_with_shortcut_self_consistency(
    first_shortcut: torch.Tensor,
    second_shortcut: torch.Tensor,
    double_shortcut: torch.Tensor,
) -> torch.Tensor:
    target = get_shortcut_target_velocity(first_shortcut, second_shortcut).detach()
    return torch.mean(torch.square(double_shortcut.float() - target.float()))
