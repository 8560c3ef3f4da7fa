"""CogView4 text-to-image training workload (``vision_ft_tpu/models/
cogview4/train_text_to_image.py`` counterpart): flow matching with sigmoid
timesteps and the velocity MSE, GLM and the VAE frozen, the size
conditioning from the dataset's original size, target size and crop.

GLM and the VAE run under ``no_grad`` every step. Draws come from one
``torch.Generator`` in a fixed order: the VAE sample, the timesteps, the
noise; :func:`loss_with_draws` takes them explicitly.

:class:`CogView4ForTextToImageTraining` adds what the Trainer calls: the
model from ``checkpoint_path`` when that file exists (seeded random weights
otherwise), gradient checkpointing, the sanity check, GLM tokenizing in
``preprocess_batch``, previews through ``generate()`` (negative prompt ""
under CFG) and the saved state: the whole model, or under PEFT the
adapters in ComfyUI keys.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
from PIL.Image import Image

from ...modules.loss.flow_match import loss_with_predicted_velocity, prepare_noised_latents
from ...modules.peft import get_adapter_parameters
from ...modules.timestep.sampling import sigmoid_randn
from ..for_training import ModelForTraining
from .config import CogView4Config
from .pipeline import CogView4Model, convert_to_comfy_key
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, pad_token_ids

SIZE_KEYS = ("original_size", "target_size", "crop_coords_top_left")


def conditioning(
    model: CogView4Model,
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
):
    """(latents, GLM features) of a batch in the model's dtype, with no
    gradient path into the frozen GLM and VAE: the penultimate hidden
    states and a sample of the VAE's distribution (noise drawn from
    ``generator`` or given), scaled."""
    dtype = model.dtype
    with torch.no_grad():
        hidden = model.text_encoder.encode_tokens(batch["input_ids"].long())
        dist = model.vae.encode(batch["pixel_values"].to(dtype))
        latents = (dist.sample(generator, vae_noise) * model.vae.scaling_factor).to(dtype)
    return latents, hidden.to(dtype)


def velocity_loss(model: CogView4Model, batch, latents, hidden, timesteps, noise):
    """The velocity MSE of the denoiser's prediction at ``timesteps`` (B,)
    for the given fp32 ``noise``."""
    timesteps = timesteps.to(latents.device)
    noisy_latents, random_noise = prepare_noised_latents(None, latents, timesteps, noise=noise)
    velocity_pred = model.denoiser(
        noisy_latents, hidden, timesteps.to(latents.dtype), *(batch[k] for k in SIZE_KEYS)
    )
    return loss_with_predicted_velocity(latents, random_noise, velocity_pred)


def loss_with_draws(
    model: CogView4Model,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
):
    """``(loss, metrics)`` for given draws: the VAE sample's noise (the
    moments' half shape), timesteps (B,) and fp32 noise of the latents'
    shape."""
    latents, hidden = conditioning(model, batch, vae_noise=vae_noise)
    return velocity_loss(model, batch, latents, hidden, timesteps, noise), {}


def loss_fn(model: CogView4Model, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
    """``(loss, metrics)`` of one batch (``pixel_values`` NHWC in [-1, 1],
    ``input_ids``, the three size rows), every draw from ``generator``."""
    latents, hidden = conditioning(model, batch, generator=generator)
    timesteps = sigmoid_randn(generator, latents.shape)
    noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
    return velocity_loss(model, batch, latents, hidden, timesteps, noise), {}


class CogView4ForTextToImageTraining(ModelForTraining):
    model: CogView4Model
    model_config: CogView4Config
    model_config_class = CogView4Config
    model_class: type[CogView4Model] = CogView4Model

    def __init__(self, trainer, config, tokenizer=None) -> None:
        self.tokenizer = tokenizer
        super().__init__(trainer, config)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def before_setup_model(self) -> None:
        pass

    def setup_model(self) -> None:
        if os.path.exists(self.model_config.checkpoint_path):
            self.model = self.model_class.from_checkpoint(
                self.model_config, tokenizer=self.tokenizer, device=self.device
            )
        else:
            # no checkpoint (tests / from scratch): seeded random weights
            self.model = self.model_class(self.model_config, tokenizer=self.tokenizer)
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(self.config.seed)
            )

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def sanity_check(self) -> None:
        cfg, dtype, device = self.model.denoiser.config, self.model.dtype, self.device
        latent = torch.zeros((1, 8, 8, cfg.in_channels), dtype=dtype, device=device)
        prompt = torch.zeros((1, 16, cfg.text_embed_dim), dtype=dtype, device=device)
        size = torch.full((1, 2), 64.0, device=device)
        with torch.no_grad():
            out = self.model.denoiser(latent, prompt, torch.full((1,), 0.5, dtype=dtype,
                                                                  device=device),
                                      size, size, torch.zeros((1, 2), device=device))
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")

    def preprocess_batch(self, batch: dict) -> dict:
        if self.model.text_encoder.tokenizer is None:
            raise RuntimeError("No tokenizer configured for TextEncoder")
        out = {
            "pixel_values": np.asarray(batch["image"], np.float32),
            "input_ids": pad_token_ids(self.model.text_encoder.tokenizer, list(batch["caption"]),
                                       DEFAULT_MAX_TOKEN_LENGTH),
            **{k: np.asarray(batch[k], np.float32) for k in SIZE_KEYS},
        }
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}

    def loss_fn(self, batch, generator):
        return loss_fn(self.model, batch, generator)

    def eval_step(self, batch):
        raise NotImplementedError

    def preview_step(self, batch: dict, preview_index: int) -> list[Image]:
        negative_prompt = batch["negative_prompt"]
        if negative_prompt is None and batch["cfg_scale"] > 0:
            negative_prompt = ""
        image = self.model.generate(
            prompt=batch["prompt"],
            negative_prompt=negative_prompt,
            height=batch["height"],
            width=batch["width"],
            cfg_scale=batch["cfg_scale"],
            num_inference_steps=batch["num_steps"],
            seed=batch["seed"],
        )[0]
        return [image]

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
