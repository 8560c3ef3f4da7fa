"""SDXL RoPE distillation training (``vision_ft_tpu/models/sdxl/
train_rope_distill.py`` counterpart): a RoPE-retrofit student (usually
through LoRA) learns to match the frozen teacher, the same weights with
RoPE and PEFT off, through four weighted loss terms: the epsilon L2, the
teacher-distill MSE, and both again on the pixels downscaled (bicubic,
antialiased) by ``lowres_ratio``.

The teacher runs under ``no_grad`` with ``while_peft_disabled`` and
``while_rope_disabled`` (its self-attention takes kernel B on the card);
the student's rotated self-attention takes kernels E and G.

``loss_fn`` draws, from the generator and in this order, the VAE
sample's noise, the integer timesteps, the noise and, when a low-res term
is on, the low-res VAE sample's noise and the low-res noise;
``loss_with_draws`` is its body for given draws.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Optional

import torch

from ...modules.loss.diffusion import add_noise, loss_with_predicted_noise
from ...modules.peft import while_peft_disabled
from ...modules.timestep.sampling import uniform_randint
from ...utils.tensor import resize_cubic
from .adapter.rope import SDXLWithRoPEConfig, SDXLWithRoPEModel, while_rope_disabled
from .train_text_to_image import SDXLForTextToImageTraining, _default_tokenizer, _latent_shape


class SDXLForRoPEDistillTrainingConfig(SDXLWithRoPEConfig):
    max_token_length: int = 225  # 75 * 3

    l2_loss_weight: float = 1.0
    distill_loss_weight: float = 1.0

    lowres_l2_loss_weight: float = 0.0
    lowres_distill_loss_weight: float = 1.0

    lowres_ratio: float = 2.0


def uses_lowres(cfg: SDXLForRoPEDistillTrainingConfig) -> bool:
    return cfg.lowres_l2_loss_weight > 0 or cfg.lowres_distill_loss_weight > 0


def downscale(cfg, pixel_values, original_size, target_size, crop_coords):
    """The low-res batch: pixels resized by 1 / ``lowres_ratio`` (sizes
    rounded up), the size conditioning divided likewise."""
    ratio = cfg.lowres_ratio
    _, h, w, _ = pixel_values.shape
    lowres = resize_cubic(pixel_values, math.ceil(h / ratio), math.ceil(w / ratio))
    return (
        lowres.to(pixel_values.dtype),
        torch.ceil(original_size / ratio),
        torch.ceil(target_size / ratio),
        torch.floor(crop_coords / ratio),
    )


def loss_with_draws(
    model: SDXLWithRoPEModel,
    cfg: SDXLForRoPEDistillTrainingConfig,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
    lowres_vae_noise: Optional[torch.Tensor] = None,
    lowres_noise: Optional[torch.Tensor] = None,
):
    """``(total, logs)`` for given draws: the VAE sample's noise, int
    timesteps (B,), the noise, and with a low-res term on the low-res VAE
    sample's noise and the low-res noise (fp32, of the low-res latents'
    shape)."""
    dtype = model.dtype
    batch_size = batch["pixel_values"].shape[0]
    with torch.no_grad():
        emb1, emb2, pooled = model.text_encoder.encode_tokens(
            batch["input_ids"], batch["input_ids"], batch_size
        )
        context = torch.cat([emb1, emb2], dim=-1).to(dtype)
        pooled = pooled.to(dtype)
        pixels = batch["pixel_values"].to(dtype)
        dist = model.vae.encode(pixels)
        latents = (dist.sample(None, vae_noise) * model.vae.scaling_factor).to(dtype)
    noisy_latents, random_noise = add_noise(latents, noise, timesteps)

    def denoise(noisy, osize, tsize, ccoords):
        return model.denoiser(noisy, timesteps.float(), context, pooled, osize, tsize, ccoords)

    def teacher(*args):
        with torch.no_grad(), while_peft_disabled(), while_rope_disabled():
            return denoise(*args)

    sizes = (batch["original_size"], batch["target_size"], batch["crop_coords_top_left"])
    logs: dict = {}
    total = torch.zeros((), dtype=torch.float32, device=latents.device)

    if cfg.distill_loss_weight > 0:
        teacher_pred = teacher(noisy_latents, *sizes)
    student_pred = denoise(noisy_latents, *sizes)
    if cfg.l2_loss_weight > 0:
        l2 = loss_with_predicted_noise(latents, random_noise, student_pred)
        logs["l2_loss"] = l2
        total = total + l2 * cfg.l2_loss_weight
    if cfg.distill_loss_weight > 0:
        distill = torch.mean(torch.square(student_pred.float() - teacher_pred.float()))
        logs["distill_loss"] = distill
        total = total + distill * cfg.distill_loss_weight

    if uses_lowres(cfg):
        lr_pixels, *lr_sizes = downscale(cfg, pixels, *sizes)
        with torch.no_grad():
            lr_dist = model.vae.encode(lr_pixels)
            lr_latents = (lr_dist.sample(None, lowres_vae_noise) * model.vae.scaling_factor).to(dtype)
        lr_noisy, lr_noise = add_noise(lr_latents, lowres_noise, timesteps)
        lr_student = denoise(lr_noisy, *lr_sizes)
        if cfg.lowres_distill_loss_weight > 0:
            lr_teacher = teacher(lr_noisy, *lr_sizes)
            lr_distill = torch.mean(torch.square(lr_student.float() - lr_teacher.float()))
            logs["lowres_distill_loss"] = lr_distill
            total = total + lr_distill * cfg.lowres_distill_loss_weight
        if cfg.lowres_l2_loss_weight > 0:
            lr_l2 = loss_with_predicted_noise(lr_latents, lr_noise, lr_student)
            logs["lowres_l2_loss"] = lr_l2
            total = total + lr_l2 * cfg.lowres_l2_loss_weight
    return total, logs


class SDXLForRoPEDistillTraining(SDXLForTextToImageTraining):
    model: SDXLWithRoPEModel
    model_config: SDXLForRoPEDistillTrainingConfig
    model_config_class = SDXLForRoPEDistillTrainingConfig

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        # the student trains with RoPE on
        self.model_config.denoiser.rope_enabled = True
        if os.path.exists(self.model_config.checkpoint_path):
            self.model = SDXLWithRoPEModel.from_checkpoint(
                self.model_config, tokenizer=tokenizer, device=self.device
            )
        else:
            self.model = SDXLWithRoPEModel(self.model_config, tokenizer=tokenizer)
            self.model.init_params(torch.Generator(device=self.device).manual_seed(self.config.seed))

    def loss_fn(self, batch, generator):
        cfg = self.model_config
        shape = _latent_shape(self.model, batch)
        device = batch["original_size"].device

        def randn(shape):
            return torch.randn(
                shape, generator=generator, dtype=torch.float32, device=generator.device
            ).to(device)

        vae_noise = randn(shape)
        timesteps = uniform_randint(generator, shape, 0, 1000).to(device)
        noise = randn(shape)
        lowres = ()
        if uses_lowres(cfg):
            b, h, w, c = shape
            ratio = int(self.model.vae.compression_ratio)
            ph, pw = batch["pixel_values"].shape[1:3]
            lr_shape = (b, math.ceil(ph / cfg.lowres_ratio) // ratio,
                        math.ceil(pw / cfg.lowres_ratio) // ratio, c)
            lowres = (randn(lr_shape), randn(lr_shape))
        return loss_with_draws(self.model, cfg, batch, vae_noise, timesteps, noise, *lowres)
