"""CogView4 text-to-image pipeline (``vision_ft_tpu/models/cogview4/
pipeline.py`` counterpart): ``CogView4Model.generate()`` (flow-match Euler
steps over a linearly time-shifted schedule, CFG, size conditioning,
optional DeepCache delta caching) and single-file checkpoint I/O.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype), ``load_state_dict`` (the JAX package's flat parameters) or
``from_checkpoint`` (a single-file safetensors checkpoint in the original
key layout: ``diffusion_model.*``, ``text_encoder.*`` for GLM and
``vae.*``; prequantized bnb / quanto weights are grouped into quantized
leaves). ``state_dict()`` writes that layout back.

``_slot_step`` is the continuous-batching unit (``serving/continuous.py``):
one Euler step over a pool of slots with per-slot plain CFG.
``generate(do_offloading=True)`` parks the text encoder, denoiser and VAE
on the host between their stages (``modules/offload.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...modules.timestep.sampling import time_shift_linear
from ...modules.offload import execution_device, stage_on_device
from ...nn import init_parameters_, load_flat_params
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from ..autoencoder import AutoencoderKL
from .config import CogView4Config
from .denoiser import Denoiser
from .scheduler import calculate_time_shift
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, TextEncoder
from .vae import DEFAULT_VAE_CONFIG

_PARTS = ("denoiser", "vae", "text_encoder")


def convert_from_original_key(key: str) -> str:
    key = key.replace("diffusion_model.", "denoiser.", 1)
    key = key.replace("text_encoder.", "text_encoder.model.", 1)
    return key


def convert_to_original_key(key: str) -> str:
    key = key.replace("denoiser.", "diffusion_model.", 1)
    key = key.replace("text_encoder.model.", "text_encoder.", 1)
    return key


convert_to_comfy_key = convert_to_original_key


class CogView4Model:
    denoiser_class: type[Denoiser] = Denoiser

    def __init__(self, config: CogView4Config, tokenizer=None, vae_config=None,
                 text_encoder_config=None):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        if tokenizer is None:
            from ..text_encoders.auto_tokenizer import maybe_auto_tokenizer

            tokenizer = maybe_auto_tokenizer(config, family="glm")
        with torch.device("meta"):
            self.denoiser = self.denoiser_class.from_config(config.denoiser)
            self.vae = AutoencoderKL(vae_config or DEFAULT_VAE_CONFIG)
            self.text_encoder = TextEncoder(config=text_encoder_config, tokenizer=tokenizer)

    @classmethod
    def from_config(cls, config: CogView4Config, **kwargs) -> "CogView4Model":
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
        return self.denoiser.proj_out.weight.device

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
        ``text_encoder.*``, as the JAX ``CogView4Model.load_state_dict``
        takes it), strict on keys and shapes, in this model's dtype, onto
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
    def from_checkpoint(cls, config: CogView4Config, tokenizer=None,
                        device: Optional[torch.device] = None, **kwargs) -> "CogView4Model":
        """The model of ``config`` (``kwargs``: the constructor's
        ``vae_config`` / ``text_encoder_config``) loaded from
        ``config.checkpoint_path`` onto ``device`` (default: the card)."""
        model = cls(config, tokenizer=tokenizer, **kwargs)
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

    def prepare_latents(self, batch_size: int, height: int, width: int,
                        seed: Optional[int] = None) -> torch.Tensor:
        ratio = int(self.vae.compression_ratio)
        shape = (batch_size, height // ratio, width // ratio, self.denoiser.config.in_channels)
        return tensor_utils.incremental_seed_randn(shape, seed, self.dtype, self.device)

    def encode_image(self, image, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A PIL image, a list of them or an NHWC tensor in [-1, 1] -> latents
        scaled by the VAE's scaling factor: a sample drawn from
        ``generator``, or the mode without one."""
        if isinstance(image, Image.Image):
            image = tensor_utils.images_to_tensor([image])
        elif isinstance(image, (list, tuple)):
            image = tensor_utils.images_to_tensor(list(image))
        dist = self.vae.encode(image.to(self.device, self.dtype))
        z = dist.sample(generator) if generator is not None else dist.mode()
        return z * self.vae.scaling_factor

    def decode_image(self, latents: torch.Tensor) -> list[Image.Image]:
        return tensor_utils.tensor_to_images(self.vae.decode(latents / self.vae.scaling_factor))

    # -- schedule --------------------------------------------------------------------

    def prepare_timesteps(self, num_inference_steps: int, height: int, width: int):
        """(timesteps (n,), sigmas (n + 1,)) fp32 numpy: integer timesteps
        from 1000 down to 1, sigmas = t / 1000 shifted linearly by the
        image's token count, then 0."""
        ratio = int(self.vae.compression_ratio)
        image_seq_len = (height // ratio) * (width // ratio) // (self.denoiser.patch_size**2)
        timesteps = np.linspace(1000.0, 1.0, num_inference_steps).astype(np.int64).astype(
            np.float32
        )
        sigmas = time_shift_linear(calculate_time_shift(image_seq_len), timesteps / 1000.0)
        sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
        return timesteps, sigmas

    # -- one step ------------------------------------------------------------------

    def _denoise_step(
        self,
        latents,
        timestep,
        sigma,
        next_sigma,
        embeddings,
        original_size,
        target_size,
        crop_coords,
        cfg_scale,
        cached_delta=None,
        do_cfg: bool = False,
        deep_cache: bool = False,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """One flow-match Euler step ``latents + velocity * (next_sigma -
        sigma)``; with ``deep_cache`` also returns the delta. As in the JAX
        package: the timestep is fed in the latents' dtype, the guidance
        and the update run in fp32 (the difference of the two halves is
        taken in the model's dtype first)."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        t = torch.full((model_input.shape[0],), float(np.float32(timestep)), dtype=torch.float32,
                       device=latents.device).to(latents.dtype)
        args = (model_input, embeddings, t, original_size, target_size, crop_coords)
        if deep_cache:
            velocity, delta = self.denoiser.deepcache_forward(
                *args, cached_delta=cached_delta, refresh=refresh, cache_depth=cache_depth
            )
        else:
            velocity, delta = self.denoiser(*args), None
        if do_cfg:
            positive, negative = velocity.chunk(2)
            velocity = negative.float() + float(np.float32(cfg_scale)) * (positive - negative).float()
        step = float(np.float32(next_sigma) - np.float32(sigma))
        new_latents = (latents.float() + velocity.float() * step).to(latents.dtype)
        return (new_latents, delta) if deep_cache else new_latents

    def _slot_step(
        self,
        latents,        # (S, h, w, c): one row a serving slot
        timestep,       # (S,) fp32: each slot's denoise position
        sigma,          # (S,) fp32
        next_sigma,     # (S,) fp32
        embeddings,     # (2S, L, D): [positives; negatives]
        original_size,  # (2S, 2)
        target_size,    # (2S, 2)
        crop_coords,    # (2S, 2)
        cfg_scale,      # (S,) fp32
        active,         # (S,) bool: inactive rows keep their latents
    ):
        """One flow-match Euler step over a slot pool with plain CFG, each
        request's scalars a per-slot vector and each slot's timestep its
        own row of the time embedding; a slot with ``cfg_scale <= 1`` takes
        the positive velocity (its negative half still computes, for one
        shape). The arithmetic is ``_denoise_step``'s."""
        s = latents.shape[0]
        expand = lambda v: v.view(-1, 1, 1, 1)
        t2 = torch.cat([timestep, timestep]).float().to(latents.dtype)
        velocity = self.denoiser(torch.cat([latents, latents]), embeddings, t2, original_size,
                                 target_size, crop_coords)
        positive, negative = velocity[:s], velocity[s:]
        guided = negative.float() + expand(cfg_scale.float()) * (positive - negative).float()
        velocity = torch.where(expand(cfg_scale > 1.0), guided, positive.float())
        new_latents = latents.float() + velocity * expand((next_sigma - sigma).float())
        return torch.where(expand(active), new_latents.to(latents.dtype), latents)

    # -- generate --------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        width: int = 768,
        height: int = 768,
        original_size=None,
        target_size=None,
        crop_coords_top_left=(0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        seed: Optional[int] = None,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
        do_offloading: bool = False,
        deep_cache_interval: Optional[int] = None,
        deep_cache_depth: Optional[int] = None,
    ) -> list[Image.Image]:
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.prepare_timesteps(num_inference_steps, height, width)
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.text_encoder, do_offloading, on):
            encoder_output = self.text_encoder.encode_prompts(
                prompt, negative_prompt, use_negative_prompts=do_cfg, max_token_length=max_token_length,
            )
        embeddings = torch.cat(
            [encoder_output.positive_embeddings, encoder_output.negative_embeddings]
        ).to(self.dtype)
        with stage_on_device(self.denoiser, do_offloading, on):
            latents = self.prepare_latents(batch_size, height, width, seed=seed)

            rows = embeddings.shape[0]

            def sizes(value):
                return torch.tensor(value, dtype=torch.float32, device=self.device).expand(rows, 2)

            conditions = (sizes(original_size), sizes(target_size), sizes(crop_coords_top_left))
            cached_delta = None
            for i, t in enumerate(timesteps):
                step_args = (latents, t, sigmas[i], sigmas[i + 1], embeddings, *conditions,
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
