"""SDXL flow-match conversion (``vision_ft_tpu/models/sdxl/adapter/
flow_match.py`` counterpart): the epsilon-trained SDXL UNet retargeted to
rectified-flow sampling.

Linear sigma schedule (timesteps 1000 -> 1, sigma = t / 1000, then 0),
Euler updates x <- x + v (next_sigma - sigma), ``model_prediction``
"velocity" or "image" (an x0 prediction converted to the velocity it
implies), ``noise_scale`` on the initial latents.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image

from ....modules.loss.flow_match import ModelPredictionType, convert_x0_to_velocity
from ..config import SDXLConfig
from ..pipeline import SDXLModel


class SDXLFlowMatchConfig(SDXLConfig):
    model_prediction: ModelPredictionType = "velocity"
    noise_scale: float = 1.0

    clean_at_zero: bool = False
    timestep_eps: float = 1e-5


class SDXLFlowMatch(SDXLModel):
    config: SDXLFlowMatchConfig

    def prepare_timesteps(self, num_inference_steps: int):
        timesteps = np.linspace(1000.0, 1.0, num_inference_steps, dtype=np.float32)
        sigmas = np.concatenate([timesteps / 1000.0, [0.0]]).astype(np.float32)
        return timesteps, sigmas

    def _fm_step(
        self, latents, timestep, sigma, next_sigma, embeddings, pooled,
        original_size, target_size, crop_coords, cfg_scale, do_cfg: bool,
    ):
        """One Euler step of the flow: the velocity (CFG-combined) times
        ``next_sigma - sigma``, added in fp32."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        batch = model_input.shape[0]
        batch_timestep = torch.full((batch,), float(timestep), device=latents.device)
        model_pred = self.denoiser(
            model_input, batch_timestep, embeddings, pooled, original_size, target_size,
            crop_coords,
        )
        if self.config.model_prediction == "image":
            velocity = convert_x0_to_velocity(
                model_pred, model_input, batch_timestep / 1000.0,
                eps=self.config.timestep_eps, clean_at_zero=self.config.clean_at_zero,
            )
        elif self.config.model_prediction == "velocity":
            velocity = model_pred
        else:
            raise ValueError(f"Unknown model_prediction: {self.config.model_prediction}")
        if do_cfg:
            # the difference in the model's dtype, the guidance in fp32, as
            # the JAX package's float32 scale promotes it
            positive, negative = velocity.chunk(2)
            velocity = negative.float() + cfg_scale * (positive - negative).float()
        new_latents = latents.float() + velocity.float() * (float(next_sigma) - float(sigma))
        return new_latents.to(latents.dtype)

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        width: int = 768,
        height: int = 768,
        original_size: Optional[tuple[int, int]] = None,
        target_size: Optional[tuple[int, int]] = None,
        crop_coords_top_left: tuple[int, int] = (0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        max_token_length: int = 75,
        seed: Optional[int] = None,
        do_offloading: bool = False,
    ) -> list[Image.Image]:
        del do_offloading  # accepted and ignored, as in the JAX package
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.prepare_timesteps(num_inference_steps)
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length,
        )
        embeddings, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        embeddings = embeddings.to(self.dtype)
        pooled = pooled.to(self.dtype)

        latents = self.prepare_latents(batch_size, height, width, 1.0, seed) * self.config.noise_scale

        def sizes(value):
            t = torch.tensor(value, dtype=torch.float32, device=latents.device)
            return t.expand(embeddings.shape[0], 2)

        for i, t in enumerate(timesteps):
            latents = self._fm_step(
                latents, t, sigmas[i], sigmas[i + 1], embeddings, pooled,
                sizes(original_size), sizes(target_size), sizes(crop_coords_top_left),
                cfg_scale, do_cfg,
            )
        return self.decode_image(latents, use_tiling=max(height, width) >= 1536)
