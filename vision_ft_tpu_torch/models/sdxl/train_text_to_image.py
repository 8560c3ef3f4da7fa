"""SDXL text-to-image training loss (``vision_ft_tpu/models/sdxl/
train_text_to_image.py`` counterpart, the body of ``loss_fn``).

Epsilon-prediction DDPM loss with uniform integer timesteps and frozen
text encoders: the conditioning comes from the batch's caches
(``cached_context`` / ``cached_pooled``, ``cached_latents``) or, for the
text, from ``encode_tokens`` under ``no_grad``. The ``ModelForTraining``
subclass (trainer hooks, preprocessing and its caches, preview, saving)
is not ported yet, and neither is VAE ``encode``: a batch without
``cached_latents`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from ...modules.loss.diffusion import (
    add_noise,
    loss_with_predicted_noise,
    min_snr_weighted_loss,
)
from ...modules.timestep.sampling import uniform_randint
from .pipeline import SDXLModel


def _cached_latents(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    if "cached_latents" not in batch:
        raise NotImplementedError(
            "the un-cached latents branch needs VAE encode, which is not ported: "
            "put cached_latents in the batch"
        )
    return batch["cached_latents"]


def conditioning(model: SDXLModel, batch: Mapping[str, torch.Tensor]):
    """(latents, context, pooled) of a batch in the model's dtype, with no
    gradient path into the frozen encoders."""
    dtype = model.dtype
    with torch.no_grad():
        if "cached_context" in batch:
            context = batch["cached_context"].to(dtype)
            pooled = batch["cached_pooled"].to(dtype)
        else:
            batch_size = batch["original_size"].shape[0]
            emb1, emb2, pooled = model.text_encoder.encode_tokens(
                batch["input_ids"], batch["input_ids"], batch_size
            )
            context = torch.cat([emb1, emb2], dim=-1).to(dtype)
            pooled = pooled.to(dtype)
        latents = _cached_latents(batch).to(dtype)
    return latents, context, pooled


def loss_with_draws(
    model: SDXLModel,
    batch: Mapping[str, torch.Tensor],
    timesteps: torch.Tensor,
    random_noise: torch.Tensor,
    min_snr_gamma: Optional[float] = None,
) -> torch.Tensor:
    """The loss for given draws: int timesteps (B,) and fp32 noise of the
    latents' shape. Noising, denoiser, plain or Min-SNR-weighted MSE."""
    latents, context, pooled = conditioning(model, batch)
    noisy_latents, random_noise = add_noise(latents, random_noise, timesteps)
    noise_pred = model.denoiser(
        noisy_latents,
        timesteps.float(),
        context,
        pooled,
        batch["original_size"],
        batch["target_size"],
        batch["crop_coords_top_left"],
    )
    if min_snr_gamma is not None:
        return min_snr_weighted_loss(
            latents, random_noise, noise_pred, timesteps, gamma=min_snr_gamma
        )
    return loss_with_predicted_noise(latents, random_noise, noise_pred)


def loss_fn(
    model: SDXLModel,
    batch: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    min_snr_gamma: Optional[float] = None,
):
    """``(loss, metrics)`` of one batch: timesteps and noise are drawn from
    ``generator`` (uniform integers in [0, 1000), unit normal noise)."""
    latents = _cached_latents(batch)
    timesteps = uniform_randint(generator, latents.shape, 0, 1000).to(latents.device)
    random_noise = torch.randn(
        latents.shape, generator=generator, dtype=torch.float32, device=generator.device
    ).to(latents.device)
    return loss_with_draws(model, batch, timesteps, random_noise, min_snr_gamma), {}
