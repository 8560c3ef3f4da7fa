"""SDXL DRaFT+ reward training (``vision_ft_tpu/models/sdxl/
train_draft_plus.py`` counterpart).

Each step samples the whole Euler-ancestral CFG chain from the batch's
initial noise: the first ``total_steps - truncation_steps`` steps as a
Python loop under ``no_grad`` (the JAX package's ``lax.scan``), the last
``truncation_steps`` with their gradient. Beside each tail step the same
UNet runs with its adapters off (``while_peft_disabled``) under
``no_grad``, for the reference prediction. The final latents are decoded
with their gradient and scored by the reward models, and

    loss = -reward_loss_scale * mean(reward) + kl_coeff * MSE(preds, reference preds)

as the JAX package completes the unfinished reference step. The
initial noise is a host numpy draw in ``preprocess_batch``; ``loss_fn``
draws the per-step ancestral noises from the generator, and
``loss_with_draws`` is its body for given noises. Each reward model's
prompt ids come from its own tokenizer (bos, the prompt cut to 75
tokens, eos, padded to 77 with eos).
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence, Union

import numpy as np
import torch
from PIL.Image import Image as PILImage

from ...config import TrainConfig
from ...modules.long_prompt import tokenize_long_prompt
from ...modules.peft import get_adapter_parameters, while_peft_disabled
from ...modules.reward import PickScoreConfig, load_reward_models
from ..for_training import ModelForTraining
from .config import SDXLConfig
from .pipeline import SDXLModel
from .text_encoder import CHUNK_LENGTH
from .train_text_to_image import _default_tokenizer
from .util import convert_to_comfy_key

RewardConfigUnion = Union[PickScoreConfig]


class SDXLForDRaFTPlusTrainingConfig(SDXLConfig):
    max_token_length: int = 225

    truncation_steps: int = 1
    total_steps: int = 25

    reward_models: list[RewardConfigUnion] = []

    cfg_scale: float = 5.0
    reward_loss_scale: float = 1.0
    kl_coeff: float = 1.0


def loss_with_draws(
    model: SDXLModel,
    cfg: SDXLForDRaFTPlusTrainingConfig,
    reward_models: Sequence,
    batch: Mapping[str, torch.Tensor],
    step_noises: Sequence[torch.Tensor],
) -> tuple[torch.Tensor, dict]:
    """``(loss, logs)`` for given per-step ancestral noises (``total_steps``
    fp32 tensors of the latents' shape). ``batch["input_ids"]`` holds the
    prompts' chunks followed by the empty negatives'."""
    dtype = model.dtype
    batch_size = batch["original_size"].shape[0]
    with torch.no_grad():
        emb1, emb2, pooled = model.text_encoder.encode_tokens(
            batch["input_ids"], batch["input_ids"], batch_size * 2
        )
        context = torch.cat([emb1, emb2], dim=-1).to(dtype)
        pooled = pooled.to(dtype)

    def cond(t):
        return torch.cat([t, t]).float()

    original_size = cond(batch["original_size"])
    target_size = cond(batch["target_size"])
    crop_coords = cond(batch["crop_coords_top_left"])

    timesteps = model.scheduler.get_timesteps(cfg.total_steps)
    sigmas = model.scheduler.get_sigmas(timesteps)
    latents = (
        batch["initial_noise"] * float(model.scheduler.get_max_noise_sigma(sigmas))
    ).to(dtype)

    def step_at(lat, i, noise):
        model_input = model.scheduler.scale_model_input(torch.cat([lat, lat]).float(), sigmas[i])
        t = torch.full((batch_size * 2,), float(timesteps[i]), device=lat.device)
        pred = model.denoiser(model_input.to(dtype), t, context, pooled, original_size,
                              target_size, crop_coords)
        positive, negative = pred.chunk(2)
        pred = negative + cfg.cfg_scale * (positive - negative)
        new_lat = model.scheduler.ancestral_step(
            lat.float(), pred.float(), sigmas[i], sigmas[i + 1], noise
        )
        return new_lat.to(dtype), pred

    n_free = cfg.total_steps - cfg.truncation_steps
    with torch.no_grad():
        for i in range(n_free):
            latents, _ = step_at(latents, i, step_noises[i])

    draftp_preds, reference_preds = [], []
    for j in range(n_free, cfg.total_steps):
        new_latents, pred = step_at(latents, j, step_noises[j])
        draftp_preds.append(pred)
        with torch.no_grad(), while_peft_disabled():
            _, reference_pred = step_at(latents, j, step_noises[j])
        reference_preds.append(reference_pred)
        latents = new_latents

    images = model.vae.decode(latents / model.vae.scaling_factor)  # NHWC [-1, 1]
    reward_total = torch.zeros((), device=images.device)
    logs: dict = {}
    for i, reward_model in enumerate(reward_models):
        scores = reward_model.score(images, batch.get(f"reward_input_ids_{i}"))
        logs[f"reward_{i}"] = scores.mean()
        reward_total = reward_total + scores.float().mean()
    reward_total = reward_total / len(reward_models)

    draftp = torch.stack(draftp_preds, dim=1).float()
    reference = torch.stack(reference_preds, dim=1).float()
    kl = torch.mean(torch.square(draftp - reference))

    loss = -cfg.reward_loss_scale * reward_total + cfg.kl_coeff * kl
    logs["reward"] = reward_total
    logs["kl"] = kl
    return loss, {k: v.detach() for k, v in logs.items()}


class SDXLForDRaFTPlusTraining(ModelForTraining):
    model: SDXLModel
    model_config: SDXLForDRaFTPlusTrainingConfig
    model_config_class = SDXLForDRaFTPlusTrainingConfig

    def __init__(self, trainer, config: TrainConfig, tokenizer=None, reward_models=None):
        self.tokenizer = tokenizer
        self.reward_models = reward_models
        super().__init__(trainer, config)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def before_setup_model(self) -> None:
        pass

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        if os.path.exists(self.model_config.checkpoint_path):
            self.model = SDXLModel.from_checkpoint(self.model_config, tokenizer=tokenizer,
                                                   device=self.device)
        else:
            self.model = SDXLModel(self.model_config, tokenizer=tokenizer)
            self.model.init_params(torch.Generator(device=self.device).manual_seed(self.config.seed))
        if self.reward_models is None:
            self.reward_models = load_reward_models(self.model_config.reward_models,
                                                    device=self.device)
        if not self.reward_models:
            raise ValueError("DRaFT+ training requires at least one reward model")

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def sanity_check(self) -> None:
        dtype, device = self.model.dtype, self.device
        cfg = self.model.denoiser.config
        latent = torch.zeros((1, 12, 12, cfg.in_channels), dtype=dtype, device=device)
        with torch.no_grad():
            out = self.model.denoiser(
                latent, torch.tensor([50.0], device=device),
                torch.zeros((1, 77, cfg.context_dim), dtype=dtype, device=device),
                torch.zeros((1, 1280), dtype=dtype, device=device),
                torch.full((1, 2), 96.0, device=device), torch.full((1, 2), 96.0, device=device),
                torch.zeros((1, 2), device=device),
            )
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")

    # -- data ---------------------------------------------------------------------------

    def preprocess_batch(self, batch: dict) -> dict:
        te = self.model.text_encoder
        captions = [te.escape_exclamation(c) for c in batch["caption"]]
        ids, _ = tokenize_long_prompt(
            te.tokenizer, captions + [""] * len(captions),
            max_length=self.model_config.max_token_length, chunk_length=CHUNK_LENGTH,
        )
        images = np.asarray(batch["image"], np.float32)
        ratio = int(self.model.vae.compression_ratio)
        noise_shape = (images.shape[0], images.shape[1] // ratio, images.shape[2] // ratio,
                       self.model.denoiser.config.in_channels)
        out = {
            "input_ids": np.asarray(ids),
            "original_size": np.asarray(batch["original_size"], np.float32),
            "target_size": np.asarray(batch["target_size"], np.float32),
            "crop_coords_top_left": np.asarray(batch["crop_coords_top_left"], np.float32),
            "initial_noise": np.random.randn(*noise_shape).astype(np.float32),
        }
        for i, reward_model in enumerate(self.reward_models):
            if getattr(reward_model, "tokenizer", None) is not None:
                out[f"reward_input_ids_{i}"] = np.asarray(
                    reward_model.tokenizer(list(batch["caption"]), max_length=77)
                )
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}

    # -- loss ------------------------------------------------------------------------------

    def loss_fn(self, batch, generator):
        shape = tuple(batch["initial_noise"].shape)
        step_noises = [
            torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device).to(batch["initial_noise"].device)
            for _ in range(self.model_config.total_steps)
        ]
        return loss_with_draws(self.model, self.model_config, self.reward_models, batch,
                               step_noises)

    # -- preview / saving ------------------------------------------------------------------

    def preview_step(self, batch: dict, preview_index: int) -> list[PILImage]:
        negative_prompt = batch["negative_prompt"]
        if negative_prompt is None and batch["cfg_scale"] > 0:
            negative_prompt = ""
        image = self.model.generate(
            prompt=batch["prompt"], negative_prompt=negative_prompt,
            height=batch["height"], width=batch["width"], cfg_scale=batch["cfg_scale"],
            num_inference_steps=batch["num_steps"], seed=batch["seed"],
            max_token_length=self.model_config.max_token_length,
        )[0]
        return [image]

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
