"""SDXL flow-match conversion training (``vision_ft_tpu/models/sdxl/
train_flow_match.py`` counterpart): the epsilon UNet retargeted to
rectified flow. A ``scale_shift_sigmoid`` (or any) timestep sampler times
1000, scaled noising with ``clean_at_zero``, velocity or image
prediction, velocity or image loss.

``loss_fn`` draws, from the generator and in this order, the VAE sample's
noise (without cached latents), the timesteps and the noise;
``loss_with_draws`` is its body for given draws.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from ...modules.loss.flow_match import (
    ModelPredictionType,
    convert_x0_to_velocity,
    loss_with_predicted_velocity,
    prepare_scaled_noised_latents,
)
from ...modules.timestep.sampling import TimestepSamplingType, sample_timestep
from .adapter.flow_match import SDXLFlowMatch, SDXLFlowMatchConfig
from .train_text_to_image import (
    SDXLForTextToImageTraining,
    _default_tokenizer,
    _latent_shape,
    conditioning,
)


class SDXLForFlowMatchingTrainingConfig(SDXLFlowMatchConfig):
    max_token_length: int = 225

    loss_type: ModelPredictionType = "velocity"

    timestep_sampling: TimestepSamplingType = "scale_shift_sigmoid"
    timestep_std: float = 0.8
    timestep_mean: float = -0.8


def sampler_kwargs(cfg: SDXLForFlowMatchingTrainingConfig) -> dict:
    if cfg.timestep_sampling == "scale_shift_sigmoid":
        return {"std": cfg.timestep_std, "mean": cfg.timestep_mean}
    if cfg.timestep_sampling == "shift_sigmoid":
        return {"discrete_flow_shift": 3.1825, "sigmoid_scale": 1}
    return {}


def treat_loss(cfg, model_pred, latents, random_noise, noisy_latents, timestep):
    """The loss of a prediction: velocity against velocity, or an image
    prediction against the latents directly or through the velocity it
    implies."""
    if cfg.model_prediction == "velocity":
        if cfg.loss_type == "velocity":
            return loss_with_predicted_velocity(latents, random_noise, model_pred)
        raise NotImplementedError(f"loss_type {cfg.loss_type} not implemented for velocity prediction")
    if cfg.model_prediction == "image":
        if cfg.loss_type == "velocity":
            target_v = convert_x0_to_velocity(
                latents, noisy_latents, timestep, eps=cfg.timestep_eps,
                clean_at_zero=cfg.clean_at_zero,
            )
            v_pred = convert_x0_to_velocity(
                model_pred, noisy_latents, timestep, eps=cfg.timestep_eps,
                clean_at_zero=cfg.clean_at_zero,
            )
            return torch.mean(torch.square(v_pred.float() - target_v.float()))
        if cfg.loss_type == "image":
            return torch.mean(torch.square(model_pred.float() - latents.detach().float()))
        raise NotImplementedError(f"loss_type {cfg.loss_type} not implemented for image prediction")
    raise ValueError(f"Unknown model_prediction: {cfg.model_prediction}")


def loss_with_draws(
    model: SDXLFlowMatch,
    cfg: SDXLForFlowMatchingTrainingConfig,
    batch: Mapping[str, torch.Tensor],
    timesteps: torch.Tensor,
    random_noise: torch.Tensor,
    vae_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The loss for given draws: timesteps (B,) in [0, 1000], fp32 unit
    noise of the latents' shape and, without cached latents, the VAE
    sample's noise."""
    latents, context, pooled = conditioning(model, batch, vae_noise=vae_noise)
    t = timesteps.float() / 1000.0
    noisy_latents, random_noise = prepare_scaled_noised_latents(
        None, latents, t, noise_scale=cfg.noise_scale, clean_at_zero=cfg.clean_at_zero,
        noise=random_noise,
    )
    model_pred = model.denoiser(
        noisy_latents, timesteps.float(), context, pooled, batch["original_size"],
        batch["target_size"], batch["crop_coords_top_left"],
    )
    return treat_loss(cfg, model_pred, latents, random_noise, noisy_latents, t)


class SDXLForFlowMatchingTraining(SDXLForTextToImageTraining):
    model: SDXLFlowMatch
    model_config: SDXLForFlowMatchingTrainingConfig
    model_config_class = SDXLForFlowMatchingTrainingConfig

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        if os.path.exists(self.model_config.checkpoint_path):
            self.model = SDXLFlowMatch.from_checkpoint(
                self.model_config, tokenizer=tokenizer, device=self.device
            )
        else:
            self.model = SDXLFlowMatch(self.model_config, tokenizer=tokenizer)
            self.model.init_params(torch.Generator(device=self.device).manual_seed(self.config.seed))

    def loss_fn(self, batch, generator):
        cfg = self.model_config
        shape = _latent_shape(self.model, batch)
        device = batch["original_size"].device
        vae_noise = None
        if "cached_latents" not in batch:
            vae_noise = torch.randn(
                shape, generator=generator, dtype=torch.float32, device=generator.device
            ).to(device)
        timesteps = (
            sample_timestep(generator, shape, cfg.timestep_sampling, **sampler_kwargs(cfg)) * 1000.0
        ).to(device)
        random_noise = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=generator.device
        ).to(device)
        loss = loss_with_draws(self.model, cfg, batch, timesteps, random_noise, vae_noise)
        return loss, {}
