"""Lumina2 text-to-image training loss (``vision_ft_tpu/models/lumina2/
train_text_to_image.py`` counterpart: the training config, the timestep
samplers and the body of ``loss_fn``).

Flow matching with Lumina2's inverted timesteps (t = 1 is the clean image:
noising uses 1 - t and the predicted velocity is negated), timesteps
"uniform", "lognorm" or "shift_fraction_uniform", an optional loss on the
4x-downsampled latents (on by default) and one on the 4x-downsampled
velocity. Gemma-2 and the VAE are frozen and run under ``no_grad`` every
step. Draws come from one ``torch.Generator`` in a fixed order: the VAE
sample, the timesteps, the noise, the low-res noise. ``loss_with_draws``
takes them explicitly.

:class:`Lumina2ForTextToImageTraining` adds what the Trainer calls: the
model from ``checkpoint_path`` when that file exists (seeded random weights
otherwise), gradient checkpointing, the sanity check, Gemma tokenizing in
``preprocess_batch``, previews through ``generate()`` and the saved state:
the whole model, or under PEFT the adapters in ComfyUI keys.
"""

from __future__ import annotations

import os
from typing import Literal, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from PIL.Image import Image

from ...modules.loss.flow_match import loss_with_predicted_velocity, prepare_noised_latents
from ...modules.peft import get_adapter_parameters
from ...modules.timestep.sampling import shift_fraction_uniform_rand, uniform_rand
from ..for_training import ModelForTraining
from .config import Lumina2Config
from .pipeline import Lumina2
from .util import convert_to_comfy_key


class Lumina2ForTextToImageTrainingConfig(Lumina2Config):
    max_token_length: int = 256

    timestep_sampling: Literal["uniform", "lognorm", "shift_fraction_uniform"] = "uniform"
    timestep_fraction_divisible: list[int] = [20, 25, 30, 32]

    use_lowres_loss: bool = True
    use_downsampled_velocity_loss: bool = False


def training_config(model: Lumina2) -> Lumina2ForTextToImageTrainingConfig:
    """The model's config when it is a training config, else its fields with
    the training defaults."""
    if isinstance(model.config, Lumina2ForTextToImageTrainingConfig):
        return model.config
    return Lumina2ForTextToImageTrainingConfig(**model.config.model_dump())


def _avg_pool_4x(x: torch.Tensor) -> torch.Tensor:
    """4x4 average pool over NHWC, a ragged edge dropped."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 4).permute(0, 2, 3, 1)


def _sample_timesteps(model, config, generator: torch.Generator, latents_shape) -> torch.Tensor:
    mode = config.timestep_sampling
    if mode == "uniform":
        return uniform_rand(generator, latents_shape)
    if mode == "lognorm":
        return model.scheduler.sample_sigmoid_randn(
            generator, latents_shape, patch_size=model.denoiser.patch_size
        )
    if mode == "shift_fraction_uniform":
        return 1 - shift_fraction_uniform_rand(
            generator, latents_shape, shift=model.scheduler.shift,
            divisible=config.timestep_fraction_divisible,
        )
    raise ValueError(f"Unknown timestep sampling method: {mode}")


def _forward_and_loss(model, latents, timesteps, captions, caption_mask, noise):
    # invert: Lumina2's t = 1 is clean
    noisy_latents, random_noise = prepare_noised_latents(None, latents, 1 - timesteps, noise=noise)
    velocity_pred, _, _ = model.denoiser(
        noisy_latents, captions, timesteps.to(latents.dtype), caption_mask
    )
    velocity_pred = -velocity_pred  # Lumina2 predicts latents - noise
    loss = loss_with_predicted_velocity(latents, random_noise, velocity_pred)
    return loss, velocity_pred, random_noise - latents


def conditioning(
    model: Lumina2,
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
):
    """(latents, caption features, caption mask) of a batch in the model's
    dtype, with no gradient path into the frozen Gemma-2 and VAE: the
    captions' penultimate hidden states and a sample of the VAE's
    distribution (noise drawn from ``generator`` or given), shifted and
    scaled."""
    dtype = model.dtype
    attention_mask = batch["attention_mask"]
    with torch.no_grad():
        hidden = model.text_encoder.encode_tokens(batch["input_ids"].long(), attention_mask)
        dist = model.vae.encode(batch["pixel_values"].to(dtype))
        z = dist.sample(generator, vae_noise)
        latents = ((z - model.vae.shift_factor) * model.vae.scaling_factor).to(dtype)
    return latents, hidden.to(dtype), attention_mask.bool()


def _loss(model, config, latents, hidden, caption_mask, timesteps, noise, lowres_noise):
    timesteps = timesteps.to(latents.device)
    loss, velocity, target = _forward_and_loss(model, latents, timesteps, hidden, caption_mask, noise)
    metrics = {"train/highres_loss": loss.detach()}
    total = loss
    if config.use_lowres_loss:
        lo_loss, _, _ = _forward_and_loss(
            model, _avg_pool_4x(latents), timesteps, hidden, caption_mask, lowres_noise
        )
        total = total + lo_loss
        metrics["train/lowres_loss"] = lo_loss.detach()
    if config.use_downsampled_velocity_loss:
        small_v = _avg_pool_4x(velocity).float()
        small_t = _avg_pool_4x(target).float()
        v_loss = torch.mean(torch.square(small_v - small_t))
        total = total + v_loss
        metrics["train/downsampled_velocity_loss"] = v_loss.detach()
    return total, metrics


def loss_with_draws(
    model: Lumina2,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
    lowres_noise: Optional[torch.Tensor] = None,
):
    """``(loss, metrics)`` for given draws: the VAE sample's noise (the
    moments' half shape), timesteps (B,) and fp32 noise of the latents'
    shape and, with the low-res loss on, of the 4x-pooled latents' shape."""
    config = training_config(model)
    latents, hidden, caption_mask = conditioning(model, batch, vae_noise=vae_noise)
    return _loss(model, config, latents, hidden, caption_mask, timesteps, noise, lowres_noise)


def loss_fn(model: Lumina2, batch: Mapping[str, torch.Tensor], generator: torch.Generator):
    """``(loss, metrics)`` of one batch (``pixel_values`` NHWC in [-1, 1],
    ``input_ids``, ``attention_mask``), every draw from ``generator``; the
    options are the model config's (:func:`training_config`)."""
    config = training_config(model)
    latents, hidden, caption_mask = conditioning(model, batch, generator=generator)
    timesteps = _sample_timesteps(model, config, generator, latents.shape)

    def randn(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)

    noise = randn(latents.shape)
    lowres_noise = randn(_avg_pool_4x(latents).shape) if config.use_lowres_loss else None
    return _loss(model, config, latents, hidden, caption_mask, timesteps, noise, lowres_noise)


class Lumina2ForTextToImageTraining(ModelForTraining):
    model: Lumina2
    model_config: Lumina2ForTextToImageTrainingConfig
    model_config_class = Lumina2ForTextToImageTrainingConfig

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
            self.model = Lumina2.from_checkpoint(
                self.model_config, tokenizer=self.tokenizer, device=self.device
            )
        else:
            # no checkpoint (tests / from scratch): seeded random weights
            self.model = Lumina2(self.model_config, tokenizer=self.tokenizer)
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(self.config.seed)
            )

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def sanity_check(self) -> None:
        denoiser = self.model.denoiser
        dtype, device = self.model.dtype, self.device
        latent = torch.zeros((1, 8, 8, denoiser.config.in_channels), dtype=dtype, device=device)
        captions = torch.zeros((1, 16, denoiser.config.caption_dim), dtype=dtype, device=device)
        mask = torch.ones((1, 16), dtype=torch.bool, device=device)
        with torch.no_grad():
            velocity, _, _ = denoiser(latent, captions, torch.full((1,), 0.1, dtype=dtype,
                                                                    device=device), mask)
        if velocity.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(velocity.shape)} for {tuple(latent.shape)}")

    def preprocess_batch(self, batch: dict) -> dict:
        ids, mask = self.model.text_encoder.tokenize(
            list(batch["caption"]), self.model_config.max_token_length
        )
        out = {
            "pixel_values": np.asarray(batch["image"], np.float32),
            "input_ids": ids,
            "attention_mask": mask,
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
            max_token_length=self.model_config.max_token_length,
        )[0]
        return [image]

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
