"""SDXL text-to-image pipeline (``vision_ft_tpu/models/sdxl/pipeline.py``
counterpart): ``SDXLModel.generate()``.

``generate()`` encodes the prompts with both CLIP towers, runs the CFG
Euler-ancestral loop over the UNet and decodes the latents with the
KL-VAE into PIL images. Latents are NHWC, as in the JAX package.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype) or ``load_state_dict`` (the JAX package's flat parameters).

The JAX ``lax.scan`` loop is a Python loop here (``_denoise_loop``), which
takes its initial latents and per-step ancestral noise as tensors;
``generate()`` draws them from generators seeded as the JAX package seeds
its own (step i: ``seed + 7919 * (i + 1)``, sample j: ``+ j``).

Not ported yet: sgm single-file checkpoint I/O, DeepCache, offloading,
tiled decode (>= 1536 px), the continuous-batching slot step, image
encode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...nn import init_parameters_, load_flat_params
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from ..autoencoder import AutoencoderKL
from ..autoencoder.kl import SDXL_VAE_CONFIG
from ..text_encoders import CLIPTokenizer
from .config import SDXLConfig
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import TextEncoder

_PARTS = ("denoiser", "vae", "text_encoder")


class SDXLModel:
    def __init__(
        self,
        config: SDXLConfig,
        tokenizer=None,
        vae_config=None,
        text_encoder_config_1=None,
        text_encoder_config_2=None,
    ):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        if tokenizer is None and config.tokenizer_path:
            tokenizer = CLIPTokenizer.from_pretrained_dir(config.tokenizer_path)
        with torch.device("meta"):
            self.denoiser = Denoiser(config.denoiser)
            self.vae = AutoencoderKL(vae_config or SDXL_VAE_CONFIG)
            self.text_encoder = TextEncoder(
                backend=config.denoiser.attention_backend,
                tokenizer=tokenizer,
                config_1=text_encoder_config_1,
                config_2=text_encoder_config_2,
            )
        self.scheduler = Scheduler()

    def _parts(self) -> dict[str, nn.Module]:
        return {name: getattr(self, name) for name in _PARTS}

    @property
    def device(self) -> torch.device:
        return next(self.denoiser.parameters()).device

    # -- parameters ------------------------------------------------------------

    def init_params(
        self,
        generator: torch.Generator,
        dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        """Seeded random weights, made on ``device`` (default: the
        generator's) in ``dtype`` (default: the config's), never through
        the host."""
        self.dtype = dtype or self.dtype
        device = generator.device if device is None else torch.device(device)
        for part in self._parts().values():
            part.to(dtype=self.dtype)
            part.to_empty(device=device)
            init_parameters_(part, generator)
            part.eval()

    def load_state_dict(
        self, flat: dict[str, np.ndarray], device: Optional[torch.device] = None
    ) -> None:
        """Load a flat internal-key state dict (``denoiser.*``, ``vae.*``,
        ``text_encoder.*``, as the JAX ``SDXLModel.load_state_dict`` takes
        it), strict on keys and shapes, in this model's dtype."""
        unknown = [k for k in flat if k.split(".", 1)[0] not in _PARTS]
        if unknown:
            raise KeyError(f"keys outside {_PARTS}: {unknown[:5]}")
        for name, part in self._parts().items():
            prefix = name + "."
            part.to(dtype=self.dtype)
            load_flat_params(
                part, {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
            )
            if device is not None:
                part.to(device)
            part.eval()

    # -- latents / images --------------------------------------------------------

    def prepare_latents(
        self,
        batch_size: int,
        height: int,
        width: int,
        max_noise_sigma: float,
        seed: Optional[int] = None,
    ) -> torch.Tensor:
        ratio = int(self.vae.compression_ratio)
        shape = (batch_size, height // ratio, width // ratio, self.denoiser.config.in_channels)
        noise = tensor_utils.incremental_seed_randn(shape, seed, self.dtype, self.device)
        return noise * max_noise_sigma

    def decode_image(self, latents: torch.Tensor, use_tiling: bool = False) -> list[Image.Image]:
        if use_tiling:
            raise NotImplementedError("tiled VAE decode is not ported yet")
        image = self.vae.decode(latents / self.vae.scaling_factor)
        return tensor_utils.tensor_to_images(image)

    # -- denoise loop ------------------------------------------------------------

    def _denoise_step(
        self, latents, timestep, sigma, next_sigma, noise, embeddings, pooled,
        original_size, target_size, crop_coords, cfg_scale, cfg_rescale, do_cfg: bool,
    ):
        """One Euler-ancestral CFG step; ``noise`` is this step's fp32
        ancestral noise, shaped like ``latents``."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        model_input = self.scheduler.scale_model_input(model_input.float(), sigma)
        model_input = model_input.to(latents.dtype)
        t = torch.full((model_input.shape[0],), float(timestep), device=latents.device)
        noise_pred = self.denoiser(
            model_input, t, embeddings, pooled, original_size, target_size, crop_coords
        )
        if do_cfg:
            positive, negative = noise_pred.float().chunk(2)
            noise_pred = negative + cfg_scale * (positive - negative)
            # CFG rescale (Lin et al. 2023, arXiv:2305.08891 sec. 3.4):
            # re-match the guided prediction's per-sample std to the
            # positive branch's, blended by cfg_rescale (0 = off)
            dims = tuple(range(1, noise_pred.ndim))
            std_pos = positive.std(dim=dims, keepdim=True, correction=0)
            std_cfg = noise_pred.std(dim=dims, keepdim=True, correction=0)
            rescaled = noise_pred * (std_pos / std_cfg.clamp_min(1e-6))
            noise_pred = cfg_rescale * rescaled + (1.0 - cfg_rescale) * noise_pred
        new_latents = self.scheduler.ancestral_step(
            latents.float(), noise_pred.float(), sigma, next_sigma, noise
        )
        return new_latents.to(latents.dtype)

    def _denoise_loop(
        self,
        latents: torch.Tensor,
        step_noises: Sequence[torch.Tensor],
        timesteps: np.ndarray,
        sigmas: np.ndarray,
        embeddings: torch.Tensor,
        pooled: torch.Tensor,
        original_size: torch.Tensor,
        target_size: torch.Tensor,
        crop_coords: torch.Tensor,
        cfg_scale: float,
        cfg_rescale: float,
        do_cfg: bool,
    ) -> torch.Tensor:
        """The sampling loop: ``len(timesteps)`` steps from ``latents``,
        step i adding ``step_noises[i]`` as its ancestral noise."""
        if len(step_noises) != len(timesteps):
            raise ValueError(f"{len(step_noises)} noises for {len(timesteps)} steps")
        for i, t in enumerate(timesteps):
            latents = self._denoise_step(
                latents, t, sigmas[i], sigmas[i + 1], step_noises[i], embeddings, pooled,
                original_size, target_size, crop_coords, cfg_scale, cfg_rescale, do_cfg,
            )
        return latents

    # -- generate --------------------------------------------------------------------

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
        cfg_rescale: float = 0.0,
        max_token_length: int = 75,
        seed: Optional[int] = None,
        deep_cache_interval: Optional[int] = None,
        do_offloading: bool = False,
    ) -> list[Image.Image]:
        if deep_cache_interval:
            raise NotImplementedError("DeepCache is not ported yet")
        if do_offloading:
            raise NotImplementedError("offloading is not ported yet")
        do_cfg = cfg_scale > 1.0
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(timesteps)
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

        latents = self.prepare_latents(
            batch_size, height, width, self.scheduler.get_max_noise_sigma(sigmas), seed
        )
        noise_seed = seed if seed is not None else int(np.random.randint(0, 2**31 - 1))
        step_noises = [
            tensor_utils.incremental_seed_randn(
                latents.shape, (noise_seed + 7919 * (i + 1)) & 0x7FFFFFFF,
                torch.float32, latents.device,
            )
            for i in range(len(timesteps))
        ]

        def sizes(value):
            t = torch.tensor(value, dtype=torch.float32, device=latents.device)
            return t.expand(embeddings.shape[0], 2)

        latents = self._denoise_loop(
            latents, step_noises, timesteps, sigmas, embeddings, pooled,
            sizes(original_size), sizes(target_size), sizes(crop_coords_top_left),
            cfg_scale, cfg_rescale, do_cfg,
        )
        return self.decode_image(latents, use_tiling=max(height, width) >= 1536)

    def prepare_encoder_hidden_states(self, encoder_output, do_cfg: bool):
        """cat(te1 768, te2 1280) -> 2048-d context; CFG doubles the batch as
        [positive; negative]."""
        te1, te2 = encoder_output.text_encoder_1, encoder_output.text_encoder_2
        positive = torch.cat([te1.positive_embeddings, te2.positive_embeddings], dim=-1)
        if not do_cfg:
            return positive, te2.pooled_positive_embeddings
        negative = torch.cat([te1.negative_embeddings, te2.negative_embeddings], dim=-1)
        embeddings = torch.cat([positive, negative], dim=0)
        pooled = torch.cat(
            [te2.pooled_positive_embeddings, te2.pooled_negative_embeddings], dim=0
        )
        return embeddings, pooled
