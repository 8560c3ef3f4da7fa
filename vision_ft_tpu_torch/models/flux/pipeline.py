"""Flux text-to-image pipeline (``vision_ft_tpu/models/flux/pipeline.py``
counterpart): ``FluxModel.generate()`` (a linear schedule walked by Euler
steps of the constant delta 1/n, distilled guidance, optional CFG and
DeepCache delta caching) and single-file checkpoint I/O.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype), ``load_state_dict`` (the JAX package's flat parameters) or
``from_checkpoint`` (a single-file safetensors checkpoint in the original
key layout: ``model.diffusion_model.*`` or ComfyUI's
``diffusion_model.*``, ``vae.*``, ``text_encoders.clip_l.transformer.*``
and ``text_encoders.t5xxl.transformer.*``; T5's ``shared`` /
``encoder.embed_tokens`` pair may hold only one of the two, a CLIP
``text_projection`` is dropped, and prequantized bnb / quanto weights are
grouped into quantized leaves). ``state_dict()`` writes the original
layout back.

``encode_image`` / ``decode_image`` scale by the VAE's scaling factor and
skip its shift factor, as the JAX package does (kept for parity).
``_slot_step`` is the continuous-batching unit (``serving/continuous.py``).
``generate(do_offloading=True)`` parks the text encoder, denoiser and VAE
on the host between their stages (``modules/offload.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...modules.timestep.scheduler import get_linear_schedule
from ...modules.offload import execution_device, stage_on_device
from ...nn import init_parameters_, load_flat_params
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from ..autoencoder import AutoencoderKL
from .config import FluxConfig
from .denoiser import Denoiser
from .text_encoder import DEFAULT_T5_MAX_TOKEN_LENGTH, TextEncoder
from .util import convert_from_original_key, convert_to_original_key
from .vae import DEFAULT_VAE_CONFIG

_PARTS = ("denoiser", "vae", "text_encoder")
# T5 ties its input embedding to the shared one; a checkpoint may hold either
_TIED = ("text_encoder.t5.shared.weight", "text_encoder.t5.encoder.embed_tokens.weight")
_DROPPED = ("text_encoder.clip.text_projection.weight",)


class FluxModel:
    denoiser_class: type[Denoiser] = Denoiser

    def __init__(self, config: FluxConfig, clip_tokenizer=None, t5_tokenizer=None,
                 vae_config=None, clip_config=None, t5_config=None):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        with torch.device("meta"):
            self.denoiser = self.denoiser_class.from_config(config.denoiser)
            self.vae = AutoencoderKL(vae_config or DEFAULT_VAE_CONFIG)
            self.text_encoder = TextEncoder(
                clip_config=clip_config, t5_config=t5_config,
                clip_tokenizer=clip_tokenizer, t5_tokenizer=t5_tokenizer,
            )

    @classmethod
    def from_config(cls, config: FluxConfig, **kwargs) -> "FluxModel":
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
        return self.denoiser.img_in.weight.device

    # -- parameters ------------------------------------------------------------

    def init_params(
        self,
        generator: torch.Generator,
        dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        """Seeded random weights, made on ``device`` (default: the
        generator's) in ``dtype`` (default: the config's), never through
        the host; T5's input embedding equals the shared one."""
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
        self.text_encoder.t5.tie_embeddings()

    def load_state_dict(
        self, flat: dict[str, np.ndarray], device: Optional[torch.device] = None
    ) -> None:
        """Load a flat internal-key state dict (``denoiser.*``, ``vae.*``,
        ``text_encoder.*``), strict on keys and shapes, in this model's
        dtype, onto ``device``: the card unless the caller names another
        (``"cpu"``); without a card the default raises."""
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

    def load_checkpoint_weights(self, device: Optional[torch.device] = None) -> None:
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
            shared, embed = _TIED
            if shared not in names and embed in names:
                names[shared] = names[embed]
            elif embed not in names and shared in names:
                names[embed] = names[shared]
            for key in _DROPPED:
                names.pop(key, None)
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
    def from_checkpoint(cls, config: FluxConfig, device: Optional[torch.device] = None,
                        **kwargs) -> "FluxModel":
        """The model of ``config`` (``kwargs``: the constructor's tokenizers
        and configs) loaded from ``config.checkpoint_path`` onto ``device``
        (default: the card)."""
        model = cls(config, **kwargs)
        model.load_checkpoint_weights(device)
        return model

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Flat dict in the original single-file key layout, the tensors as
        the modules hold them (on their device)."""
        return {
            convert_to_original_key(f"{name}.{k}"): v
            for name, part in self._parts().items() for k, v in part.state_dict().items()
        }

    # -- latents / images --------------------------------------------------------

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        seed: Optional[int] = None) -> torch.Tensor:
        ratio = int(self.vae.compression_ratio)
        shape = (batch_size, height // ratio, width // ratio, self.vae.config.latent_channels)
        return tensor_utils.incremental_seed_randn(shape, seed, self.dtype, self.device)

    def encode_image(self, image, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A PIL image, a list of them or an NHWC tensor in [-1, 1] -> latents
        scaled by the VAE's scaling factor (its shift factor skipped, as in
        the JAX package): a sample drawn from ``generator``, or the mode."""
        if isinstance(image, Image.Image):
            image = tensor_utils.images_to_tensor([image])
        elif isinstance(image, (list, tuple)):
            image = tensor_utils.images_to_tensor(list(image))
        dist = self.vae.encode(image.to(self.device, self.dtype))
        z = dist.sample(generator) if generator is not None else dist.mode()
        return z * self.vae.scaling_factor

    def decode_image(self, latents: torch.Tensor) -> list[Image.Image]:
        return tensor_utils.tensor_to_images(self.vae.decode(latents / self.vae.scaling_factor))

    # -- one step ------------------------------------------------------------------

    def _denoise_step(
        self,
        latents,
        timestep,
        delta,
        t5_emb,
        clip_emb,
        guidance,
        cfg_scale,
        cached_delta=None,
        do_cfg: bool = False,
        deep_cache: bool = False,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """One Euler step ``latents - velocity * delta``; with
        ``deep_cache`` also returns the DeepCache delta. As in the JAX
        package: the timestep and the guidance are fed in the latents'
        dtype, the guidance and the update run in fp32 (the difference of
        the two halves is taken in the model's dtype first)."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        batch = model_input.shape[0]

        def per_row(value):
            return torch.full((batch,), float(np.float32(value)), dtype=torch.float32,
                              device=latents.device).to(latents.dtype)

        t, g = per_row(timestep), per_row(guidance)
        if deep_cache:
            velocity, dc_delta = self.denoiser.deepcache_forward(
                model_input, t5_emb, t, clip_emb, guidance=g, cached_delta=cached_delta,
                refresh=refresh, cache_depth=cache_depth,
            )
        else:
            velocity, dc_delta = self.denoiser(model_input, t5_emb, t, clip_emb, guidance=g), None
        if do_cfg:
            positive, negative = velocity.chunk(2)
            velocity = negative.float() + float(np.float32(cfg_scale)) * (positive - negative).float()
        new_latents = latents.float() - velocity.float() * float(np.float32(delta))
        new_latents = new_latents.to(latents.dtype)
        return (new_latents, dc_delta) if deep_cache else new_latents

    def _slot_step(
        self,
        latents,      # (S, h, w, c): one row a serving slot
        timestep,     # (S,) fp32: each slot's denoise position
        total_steps,  # (S,) int: each slot's step count (delta = 1 / total)
        t5_emb,       # (2S, L, D): [positives; negatives]
        clip_emb,     # (2S, P)
        guidance,     # (S,) fp32: each slot's distilled guidance
        cfg_scale,    # (S,) fp32
        active,       # (S,) bool: inactive rows keep their latents
    ):
        """One Euler step over a slot pool: the constant delta 1/n of
        ``generate()`` from each slot's ``total_steps``, the distilled
        guidance and CFG per slot; a slot with ``cfg_scale <= 1`` takes the
        positive velocity (its negative half still computes, for one
        shape). The guidance embedding is gated per row (the denoiser's
        docstring), so a slot's result does not depend on its neighbours'
        guidance. The arithmetic is ``_denoise_step``'s."""
        s = latents.shape[0]
        expand = lambda v: v.view(-1, 1, 1, 1)
        t2 = torch.cat([timestep, timestep]).float().to(latents.dtype)
        g2 = torch.cat([guidance, guidance]).float().to(latents.dtype)
        velocity = self.denoiser(torch.cat([latents, latents]), t5_emb, t2, clip_emb, guidance=g2)
        positive, negative = velocity[:s], velocity[s:]
        guided = negative.float() + expand(cfg_scale.float()) * (positive - negative).float()
        velocity = torch.where(expand(cfg_scale > 1.0), guided, positive.float())
        delta = 1.0 / torch.clamp(total_steps.float(), min=1.0)
        new_latents = latents.float() - velocity.float() * expand(delta)
        return torch.where(expand(active), new_latents.to(latents.dtype), latents)

    # -- generate --------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        width: int = 768,
        height: int = 768,
        num_inference_steps: int = 20,
        cfg_scale: float = 1.0,
        distilled_guidance_scale: float = 1.0,
        seed: Optional[int] = None,
        max_token_length: int = DEFAULT_T5_MAX_TOKEN_LENGTH,
        do_offloading: bool = False,
        deep_cache_interval: Optional[int] = None,
        deep_cache_depth: Optional[int] = None,
    ) -> list[Image.Image]:
        do_cfg = cfg_scale > 1.0
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.text_encoder, do_offloading, on):
            encoder_output = self.text_encoder.encode_prompts(
                prompt, negative_prompt, use_negative_prompts=do_cfg,
                t5_max_token_length=max_token_length,
            )
        t5_emb = torch.cat(
            [encoder_output.t5.positive_embeddings, encoder_output.t5.negative_embeddings]
        ).to(self.dtype)
        clip_emb = torch.cat(
            [encoder_output.clip.positive_embeddings, encoder_output.clip.negative_embeddings]
        ).to(self.dtype)

        with stage_on_device(self.denoiser, do_offloading, on):
            latents = self.prepare_latents(batch_size, height, width, seed=seed)
            timesteps = get_linear_schedule(num_inference_steps)
            delta = 1.0 / num_inference_steps

            cached_delta = None
            for i, t in enumerate(timesteps):
                step_args = (latents, t, delta, t5_emb, clip_emb, distilled_guidance_scale,
                             cfg_scale)
                if deep_cache_interval:
                    refresh = (i % deep_cache_interval == 0) or cached_delta is None
                    latents, cached_delta = self._denoise_step(
                        *step_args, None if refresh else cached_delta, do_cfg=do_cfg,
                        deep_cache=True, refresh=refresh, cache_depth=deep_cache_depth,
                    )
                else:
                    latents = self._denoise_step(*step_args, do_cfg=do_cfg)
        with stage_on_device(self.vae, do_offloading, on):
            return self.decode_image(latents)
