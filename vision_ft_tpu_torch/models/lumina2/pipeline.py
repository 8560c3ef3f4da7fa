"""Lumina2 text-to-image pipeline (``vision_ft_tpu/models/lumina2/
pipeline.py`` counterpart): ``Lumina2.generate()`` with renorm CFG, CFG
truncation, refined-caption caching and optional DeepCache delta caching
(``deep_cache_interval``; see ``NextDiT.deepcache_forward``).

``generate()`` encodes the prompts with Gemma-2, runs the flow-match Euler
loop over the NextDiT (one latent resolution per call; NHWC latents) and
decodes the latents with the 16-channel KL-VAE into PIL images.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype), ``load_state_dict`` (the JAX package's flat parameters) or
``from_checkpoint`` (a single-file safetensors checkpoint in the original
key layout, ``model.diffusion_model.*``,
``text_encoders.gemma2_2b.transformer.*`` and ``vae.*``, the JAX
package's ``state_dict()`` layout; prequantized bnb/quanto weights are
grouped into quantized leaves). ``state_dict()`` writes that layout back.

``encode_image`` is the VAE encode of the train step's latents.
``_slot_step`` is the continuous-batching unit (``serving/continuous.py``):
one flow-match Euler step over a pool of slots with per-slot guidance,
renorm and CFG truncation. ``generate(do_offloading=True)`` parks the text
encoder, denoiser and VAE on the host between their stages
(``modules/offload.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...modules.offload import execution_device, stage_on_device
from ...nn import init_parameters_, load_flat_params
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from ..autoencoder import AutoencoderKL
from .config import Lumina2Config
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, TextEncoder
from .util import convert_from_original_key, convert_to_original_key
from .vae import DEFAULT_VAE_CONFIG

_PARTS = ("denoiser", "vae", "text_encoder")


class Lumina2:
    denoiser_class: type[Denoiser] = Denoiser

    def __init__(
        self,
        config: Lumina2Config,
        tokenizer=None,
        vae_config=None,
        text_encoder_config=None,
    ):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        if tokenizer is None:
            from ..text_encoders.auto_tokenizer import maybe_auto_tokenizer

            tokenizer = maybe_auto_tokenizer(config, family="gemma")
        with torch.device("meta"):
            self.denoiser = self.denoiser_class(config.denoiser)
            self.vae = AutoencoderKL(vae_config or DEFAULT_VAE_CONFIG)
            self.text_encoder = TextEncoder(config=text_encoder_config, tokenizer=tokenizer)
        self.scheduler = Scheduler()

    @classmethod
    def from_config(cls, config: Lumina2Config, **kwargs) -> "Lumina2":
        return cls(config, **kwargs)

    def _parts(self) -> dict[str, nn.Module]:
        return {name: getattr(self, name) for name in _PARTS}

    def as_module(self) -> nn.ModuleDict:
        """The three parts as one module (the same modules, not copies),
        keyed ``denoiser.*``, ``vae.*``, ``text_encoder.*`` as the JAX
        package's flattened params."""
        return nn.ModuleDict(self._parts())

    @property
    def device(self) -> torch.device:
        return self.denoiser.x_embedder.weight.device

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
            if any(t.is_meta for t in (*part.parameters(), *part.buffers())):
                part.to_empty(device=device)
            else:
                part.to(device)
            init_parameters_(part, generator)
            part.eval()

    def load_state_dict(
        self, flat: dict[str, np.ndarray], device: Optional[torch.device] = None
    ) -> None:
        """Load a flat internal-key state dict (``denoiser.*``, ``vae.*``,
        ``text_encoder.*``, as the JAX ``Lumina2.load_state_dict`` takes
        it), strict on keys and shapes, in this model's dtype, onto
        ``device``: the card unless the caller names another (``"cpu"``);
        without a card the default raises."""
        device = torch.device("cuda" if device is None else device)
        unknown = [k for k in flat if k.split(".", 1)[0] not in _PARTS]
        if unknown:
            raise KeyError(f"keys outside {_PARTS}: {unknown[:5]}")
        for name, part in self._parts().items():
            prefix = name + "."
            part.to(dtype=self.dtype)
            load_flat_params(
                part, {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
            )
            part.to(device)
            part.eval()

    # -- checkpoint I/O ------------------------------------------------------------

    def _from_checkpoint(self, device: Optional[torch.device] = None) -> None:
        """Load ``config.checkpoint_path`` in this model's dtype onto
        ``device`` (default: the card), one part at a time and each tensor
        on its own from the file to the device, so the host never holds a
        whole copy of the file. Keys outside the three parts are skipped,
        as the JAX package skips them; within a part the load is strict."""
        from safetensors import safe_open

        from ...modules.quant import convert_prequantized_state_dict

        device = torch.device("cuda" if device is None else device)
        with safe_open(str(self.config.checkpoint_path), framework="pt", device="cpu") as f:
            names = {convert_from_original_key(k): k for k in f.keys()}
            for name, part in self._parts().items():
                prefix = name + "."
                flat = {}
                for key, original in names.items():
                    if key.startswith(prefix):
                        value = f.get_tensor(original)
                        dtype = self.dtype if value.is_floating_point() else value.dtype
                        flat[key[len(prefix):]] = value.to(device=device, dtype=dtype)
                part.to(dtype=self.dtype)
                load_flat_params(part, convert_prequantized_state_dict(flat), meta_device=device)
                del flat
                part.to(device)
                part.eval()

    @classmethod
    def from_checkpoint(
        cls, config: Lumina2Config, tokenizer=None, device: Optional[torch.device] = None
    ) -> "Lumina2":
        model = cls(config, tokenizer=tokenizer)
        model._from_checkpoint(device)
        return model

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Flat dict in the original single-file key layout, the tensors as
        the modules hold them (on their device)."""
        return {
            convert_to_original_key(f"{name}.{k}"): v
            for name, part in self._parts().items() for k, v in part.state_dict().items()
        }

    # -- latents / images --------------------------------------------------------

    def prepare_latents(
        self, batch_size: int, height: int, width: int, seed: Optional[int] = None
    ) -> torch.Tensor:
        ratio = int(self.vae.compression_ratio)
        shape = (batch_size, height // ratio, width // ratio, self.denoiser.config.in_channels)
        return tensor_utils.incremental_seed_randn(shape, seed, self.dtype, self.device)

    def encode_image(self, image, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A PIL image, a list of them or an NHWC tensor in [-1, 1] -> scaled
        latents: a sample of the VAE's distribution drawn from ``generator``,
        or its mode without one."""
        if isinstance(image, Image.Image):
            image = tensor_utils.images_to_tensor([image])
        elif isinstance(image, (list, tuple)):
            image = tensor_utils.images_to_tensor(list(image))
        dist = self.vae.encode(image.to(self.device, self.dtype))
        z = dist.sample(generator) if generator is not None else dist.mode()
        return (z - self.vae.shift_factor) * self.vae.scaling_factor

    def decode_image(self, latents: torch.Tensor) -> list[Image.Image]:
        z = latents / self.vae.scaling_factor + self.vae.shift_factor
        return tensor_utils.tensor_to_images(self.vae.decode(z))

    # -- one CFG step ------------------------------------------------------------

    def _denoise_step(
        self,
        latents,
        timestep,
        sigma,
        next_sigma,
        caption_features,
        caption_mask,
        cached_features,
        cfg_scale,
        renorm_cfg_scale,
        cached_delta=None,
        do_cfg: bool = False,
        use_cache: bool = False,
        deep_cache: bool = False,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """One flow-match Euler step. Returns (latents, refined captions)
        and, with ``deep_cache``, the delta. The guidance arithmetic runs in
        fp32, as the JAX package's does (its fp32 scalars promote it)."""
        batch = latents.shape[0]
        latents_input = torch.cat([latents, latents]) if do_cfg else latents
        t = torch.full(
            (latents_input.shape[0],), float(timestep), dtype=torch.float32, device=latents.device
        )
        cached = cached_features if use_cache else None
        if deep_cache:
            velocity, _mask, refined, delta = self.denoiser.deepcache_forward(
                latents_input, caption_features, t, caption_mask,
                cached_caption_features=cached, cached_delta=cached_delta,
                refresh=refresh, cache_depth=cache_depth,
            )
        else:
            velocity, _mask, refined = self.denoiser(
                latents_input, caption_features, t, caption_mask,
                cached_caption_features=cached,
            )
            delta = None
        velocity = velocity.float()
        if do_cfg:
            positive, negative = velocity[:batch], velocity[batch:]
            new_velocity = negative + float(cfg_scale) * (positive - negative)
            # renorm CFG: the norm runs over NHWC axis 2 (the W axis)
            if renorm_cfg_scale > 0.0:
                positive_norm = torch.linalg.vector_norm(positive, dim=2, keepdim=True)
                new_norm = torch.linalg.vector_norm(new_velocity, dim=2, keepdim=True)
                scale = positive_norm * float(renorm_cfg_scale) / new_norm.clamp_min(1e-12)
                new_velocity = new_velocity * scale
            velocity = new_velocity
        new_latents = latents.float() + velocity * (float(sigma) - float(next_sigma))
        new_latents = new_latents.to(latents.dtype)
        if deep_cache:
            return new_latents, refined, delta
        return new_latents, refined

    # -- continuous-batching slot step ---------------------------------------------

    def _slot_step(
        self,
        latents,           # (S, h, w, c): one row a serving slot
        timestep,          # (S,) fp32: each slot's denoise position
        sigma,             # (S,) fp32
        next_sigma,        # (S,) fp32
        caption_features,  # (2S, L, D): [positives; negatives]
        caption_mask,      # (2S, L)
        cfg_scale,         # (S,) fp32
        renorm_cfg_scale,  # (S,) fp32
        cfg_trunc_ratio,   # (S,) fp32
        step_idx,          # (S,) int
        total_steps,       # (S,) int
        active,            # (S,) bool: inactive rows keep their latents
    ):
        """One flow-match Euler step over a slot pool: every per-request
        scalar of ``_denoise_step`` is a per-slot vector, the CFG-truncation
        gate too (``(i + 1) / n > ratio``): a truncated slot takes the bare
        positive velocity (its negative half still computes, for one
        shape). The captions are refined again each step, as in the JAX
        package (no caption cache in a pool)."""
        s = latents.shape[0]
        expand = lambda v: v.view(-1, 1, 1, 1)
        t2 = torch.cat([timestep, timestep]).float()
        velocity, _mask, _refined = self.denoiser(
            torch.cat([latents, latents]), caption_features, t2, caption_mask,
            cached_caption_features=None,
        )
        velocity = velocity.float()
        positive, negative = velocity[:s], velocity[s:]
        cfg, renorm = expand(cfg_scale.float()), expand(renorm_cfg_scale.float())
        guided = negative + cfg * (positive - negative)
        # renorm CFG: the norm runs over NHWC axis 2 (the W axis)
        positive_norm = torch.linalg.vector_norm(positive, dim=2, keepdim=True)
        new_norm = torch.linalg.vector_norm(guided, dim=2, keepdim=True)
        scale = torch.where(renorm > 0.0, positive_norm * renorm / new_norm.clamp_min(1e-12),
                            torch.ones_like(new_norm))
        ratio = (step_idx.float() + 1.0) / total_steps.float()
        do_cfg_step = (cfg_scale > 1.0) & (ratio > cfg_trunc_ratio)
        velocity = torch.where(expand(do_cfg_step), guided * scale, positive)
        new_latents = latents.float() + velocity * expand((sigma - next_sigma).float())
        return torch.where(expand(active), new_latents.to(latents.dtype), latents)

    # -- generate --------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        width: int = 768,
        height: int = 768,
        num_inference_steps: int = 25,
        cfg_scale: float = 5.0,
        renorm_cfg_scale: float = 1.0,
        cfg_truncation_ratio: float = 0.0,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
        seed: Optional[int] = None,
        do_offloading: bool = False,
        deep_cache_interval: Optional[int] = None,
        deep_cache_depth: Optional[int] = None,
    ) -> list[Image.Image]:
        do_cfg = cfg_scale > 1.0
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(num_inference_steps)
        prompts = list(prompt) if isinstance(prompt, (list, tuple)) else [prompt]

        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.text_encoder, do_offloading, on):
            encoder_output = self.text_encoder.encode_prompts(
                prompts, negative_prompt, use_negative_prompts=do_cfg,
                max_token_length=max_token_length,
            )
        with stage_on_device(self.denoiser, do_offloading, on):
            latents = self.prepare_latents(len(prompts), height, width, seed=seed)

            cached_features = None
            cached_was_cfg = None
            cached_delta = None
            for i, t in enumerate(timesteps):
                current_step_ratio = (i + 1) / num_inference_steps
                do_cfg_step = do_cfg and current_step_ratio > cfg_truncation_ratio

                if do_cfg_step:
                    caption_features = torch.cat(
                        [encoder_output.positive_embeddings, encoder_output.negative_embeddings]
                    ).to(self.dtype)
                    caption_mask = torch.cat(
                        [encoder_output.positive_attention_mask,
                         encoder_output.negative_attention_mask]
                    )
                else:
                    caption_features = encoder_output.positive_embeddings.to(self.dtype)
                    caption_mask = encoder_output.positive_attention_mask

                # drop the caches when the CFG batch size changes
                if cached_was_cfg is not None and cached_was_cfg != do_cfg_step:
                    cached_features = None
                    cached_delta = None
                use_cache = cached_features is not None

                step_args = (
                    latents, t, sigmas[i], sigmas[i + 1], caption_features, caption_mask,
                    cached_features, cfg_scale, renorm_cfg_scale,
                )
                if deep_cache_interval:
                    refresh = (i % deep_cache_interval == 0) or cached_delta is None
                    latents, refined, cached_delta = self._denoise_step(
                        *step_args, None if refresh else cached_delta, do_cfg=do_cfg_step,
                        use_cache=use_cache, deep_cache=True, refresh=refresh,
                        cache_depth=deep_cache_depth,
                    )
                else:
                    latents, refined = self._denoise_step(
                        *step_args, do_cfg=do_cfg_step, use_cache=use_cache
                    )
                cached_features = refined
                cached_was_cfg = do_cfg_step
        with stage_on_device(self.vae, do_offloading, on):
            return self.decode_image(latents)
