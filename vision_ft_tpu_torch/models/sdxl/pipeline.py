"""SDXL text-to-image pipeline (``vision_ft_tpu/models/sdxl/pipeline.py``
counterpart): ``SDXLModel.generate()``.

``generate()`` encodes the prompts with both CLIP towers, runs the CFG
Euler-ancestral loop over the UNet and decodes the latents with the
KL-VAE into PIL images. Latents are NHWC, as in the JAX package.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype), ``load_state_dict`` (the JAX package's flat parameters) or
``from_checkpoint`` (an sgm single-file safetensors checkpoint, the JAX
package's ``state_dict()`` layout: its keys converted, the OpenCLIP
tower's fused qkv split, the VAE's 1x1-conv attention weights reshaped to
linears and prequantized bnb/quanto weights grouped into quantized
leaves). ``state_dict()`` writes that layout back. Without a tokenizer
passed in, one comes from ``maybe_auto_tokenizer(config, family="clip")``:
``tokenizer_path``, else a ``checkpoint_path`` directory that holds the
assets (``vocab.json`` + ``merges.txt``, ``tokenizer.json`` or a
SentencePiece model), as in the JAX package.

The JAX ``lax.scan`` loop is a Python loop here (``_denoise_loop``), which
takes its initial latents and per-step ancestral noise as tensors;
``generate()`` draws them from generators seeded as the JAX package seeds
its own (step i: ``seed + 7919 * (i + 1)``, sample j: ``+ j``). With
``deep_cache_interval=N`` the loop runs DeepCache (``UNet.deepcache_forward``):
a full pass on steps ``i % N == 0``, the shallow blocks around the cached
deep feature between them (the JAX ``lax.cond`` is a Python branch). At
1536 px and up the VAE decodes in tiles (``AutoencoderKL.tiled_decode``).

``_slot_step`` is the continuous-batching unit (``serving/continuous.py``):
one CFG Euler-ancestral step over a pool of slots, each request's scalars a
per-slot vector, slot j's step-i noise drawn from its own generator seeded
``(seed_j + 7919 * (i + 1)) & 0x7FFFFFFF`` (``slot_noise``), the stream of
batch-1 ``generate()``.

``generate(do_offloading=True)`` parks the text encoder, denoiser and VAE
on the host between their stages (``modules/offload.py``).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image
from torch import nn

from ...modules.offload import execution_device, stage_on_device
from ...nn import Conv2d, Linear, init_parameters_, load_flat_params, weight_device
from ...utils import safetensors as st
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from ...utils.state_dict import (
    convert_open_clip_to_transformers,
    convert_transformers_to_open_clip,
)
from ..autoencoder import AutoencoderKL
from ..autoencoder.kl import SDXL_VAE_CONFIG
from .config import SDXLConfig
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import TextEncoder
from .util import convert_from_original_key, convert_to_original_key

_PARTS = ("denoiser", "vae", "text_encoder")
_VAE_ATTN_WEIGHT = re.compile(r"vae\..*\.to_(q|k|v|out)\.(\d+\.)?weight$")


class SDXLModel:
    # the UNet class: adapter models (the RoPE retrofit, the IP-Adapter)
    # build a subclass with their own attention or transformer block
    denoiser_class: type = Denoiser
    # the text encoder class: the style tokenizer builds one that scatters
    # style vectors into both towers
    text_encoder_class: type = TextEncoder

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
        if tokenizer is None:
            from ..text_encoders.auto_tokenizer import maybe_auto_tokenizer

            tokenizer = maybe_auto_tokenizer(config, family="clip")
        with torch.device("meta"):
            self.denoiser = self.denoiser_class(config.denoiser)
            self.vae = AutoencoderKL(vae_config or SDXL_VAE_CONFIG)
            self.text_encoder = self.text_encoder_class(
                backend=config.denoiser.attention_backend,
                tokenizer=tokenizer,
                config_1=text_encoder_config_1,
                config_2=text_encoder_config_2,
            )
        self.scheduler = Scheduler()

    def _parts(self) -> dict[str, nn.Module]:
        return {name: getattr(self, name) for name in _PARTS}

    def as_module(self) -> nn.ModuleDict:
        """The three parts as one module (the same modules, not copies),
        keyed ``denoiser.*``, ``vae.*``, ``text_encoder.*`` as the JAX
        package's flattened params."""
        return nn.ModuleDict(self._parts())

    @property
    def device(self) -> torch.device:
        first = next(m for m in self.denoiser.modules() if isinstance(m, (Linear, Conv2d)))
        return weight_device(first)

    # -- parameters ------------------------------------------------------------

    def init_params(
        self,
        generator: torch.Generator,
        dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        """Seeded random weights, made on ``device`` (default: the
        generator's) in ``dtype`` (default: the config's), never through
        the host. A model that holds weights already is moved, not emptied:
        its quantized weights keep their leaves and their dtypes, its dense
        ones are drawn again."""
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
        ``text_encoder.*``, as the JAX ``SDXLModel.load_state_dict`` takes
        it), strict on keys and shapes, in this model's dtype (the leaves of
        quantized weights in their own), onto ``device``: the card unless
        the caller names another (``"cpu"``); without a card the default
        raises."""
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
        """Load ``config.checkpoint_path`` (sgm single-file layout) in this
        model's dtype onto ``device`` (default: the card)."""
        from ...modules.quant import convert_prequantized_state_dict

        state_dict = st.load_file(self.config.checkpoint_path, dtype=self.dtype)
        state_dict = {convert_from_original_key(k): v for k, v in state_dict.items()}
        # OpenCLIP -> transformers for text_encoder_2 (the qkv split)
        te2 = convert_open_clip_to_transformers(
            {k: v for k, v in state_dict.items() if "text_encoder_2." in k}
        )
        state_dict = {
            **{k: v for k, v in state_dict.items() if "text_encoder_2." not in k},
            **te2,
        }
        # HF bookkeeping keys, if present
        state_dict = {k: v for k, v in state_dict.items() if ".embeddings.position_ids" not in k}
        # sgm stores the VAE attention as 1x1 convs; the modules use linears
        state_dict = {
            k: (v[:, :, 0, 0] if _VAE_ATTN_WEIGHT.search(k) and v.ndim == 4 else v)
            for k, v in state_dict.items()
        }
        state_dict = convert_prequantized_state_dict(state_dict)
        self.load_state_dict(state_dict, device=device)

    @classmethod
    def from_checkpoint(
        cls, config: SDXLConfig, tokenizer=None, device: Optional[torch.device] = None
    ) -> "SDXLModel":
        model = cls(config, tokenizer=tokenizer)
        model._from_checkpoint(device)
        return model

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Flat dict in the sgm single-file key layout, the tensors as the
        modules hold them (on their device)."""
        flat = {
            f"{name}.{k}": v for name, part in self._parts().items()
            for k, v in part.state_dict().items()
        }
        te2 = convert_transformers_to_open_clip(
            {k: v for k, v in flat.items() if k.startswith("text_encoder.text_encoder_2.")}
        )
        flat = {
            **{k: v for k, v in flat.items() if not k.startswith("text_encoder.text_encoder_2.")},
            **te2,
        }
        flat = {
            k: (v[:, :, None, None] if _VAE_ATTN_WEIGHT.search(k) and v.ndim == 2 else v)
            for k, v in flat.items()
        }
        return {convert_to_original_key(k): v for k, v in flat.items()}

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
        z = latents / self.vae.scaling_factor
        image = self.vae.tiled_decode(z) if use_tiling else self.vae.decode(z)
        return tensor_utils.tensor_to_images(image)

    # -- denoise loop ------------------------------------------------------------

    def _denoise_step(
        self, latents, timestep, sigma, next_sigma, noise, embeddings, pooled,
        original_size, target_size, crop_coords, cfg_scale, cfg_rescale, do_cfg: bool,
        cached_deep=None, refresh: Optional[bool] = None, cross_attention_kwargs=None,
    ):
        """One Euler-ancestral CFG step; ``noise`` is this step's fp32
        ancestral noise, shaped like ``latents``. With ``refresh`` set
        (True or False) it is a DeepCache step and returns (latents, deep
        feature). ``cross_attention_kwargs`` reach every attn2 (adapters)."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        model_input = self.scheduler.scale_model_input(model_input.float(), sigma)
        model_input = model_input.to(latents.dtype)
        t = torch.full((model_input.shape[0],), float(timestep), device=latents.device)
        unet_args = (model_input, t, embeddings, pooled, original_size, target_size, crop_coords)
        if refresh is not None:
            noise_pred, deep = self.denoiser.deepcache_forward(
                *unet_args, cached_deep=cached_deep, refresh=refresh,
                cross_attention_kwargs=cross_attention_kwargs,
            )
        else:
            noise_pred = self.denoiser(*unet_args, cross_attention_kwargs=cross_attention_kwargs)
        if do_cfg:
            positive, negative = noise_pred.float().chunk(2)
            noise_pred = _guidance(positive, negative, cfg_scale, cfg_rescale)
        new_latents = self.scheduler.ancestral_step(
            latents.float(), noise_pred.float(), sigma, next_sigma, noise
        ).to(latents.dtype)
        return new_latents if refresh is None else (new_latents, deep)

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
        deep_cache_interval: Optional[int] = None,
        cross_attention_kwargs: Optional[dict] = None,
    ) -> torch.Tensor:
        """The sampling loop: ``len(timesteps)`` steps from ``latents``,
        step i adding ``step_noises[i]`` as its ancestral noise; with
        ``deep_cache_interval=N``, DeepCache refreshing on ``i % N == 0``."""
        if len(step_noises) != len(timesteps):
            raise ValueError(f"{len(step_noises)} noises for {len(timesteps)} steps")
        deep = None
        for i, t in enumerate(timesteps):
            args = (latents, t, sigmas[i], sigmas[i + 1], step_noises[i], embeddings, pooled,
                    original_size, target_size, crop_coords, cfg_scale, cfg_rescale, do_cfg)
            if deep_cache_interval:
                latents, deep = self._denoise_step(
                    *args, cached_deep=deep, refresh=i % deep_cache_interval == 0,
                    cross_attention_kwargs=cross_attention_kwargs,
                )
            else:
                latents = self._denoise_step(*args, cross_attention_kwargs=cross_attention_kwargs)
        return latents

    # -- continuous-batching slot step -------------------------------------------

    @staticmethod
    def slot_noise(seeds, step_idx, shape, device) -> torch.Tensor:
        """The fp32 ancestral noise of a slot pool's step: slot j's from a
        generator seeded ``(seeds[j] + 7919 * (step_idx[j] + 1)) &
        0x7FFFFFFF`` (batch-1 ``generate()``'s stream for its step). The
        seeds and indices are host integers (a sequence, array or CPU
        tensor)."""
        rows = []
        for seed, i in zip(np.asarray(seeds).tolist(), np.asarray(step_idx).tolist()):
            generator = torch.Generator(device=device).manual_seed(
                (int(seed) + 7919 * (int(i) + 1)) & 0x7FFFFFFF
            )
            rows.append(torch.randn(shape, generator=generator, device=device))
        return torch.stack(rows)

    def _slot_step(
        self,
        latents,        # (S, h, w, c): one row a serving slot
        timestep,       # (S,) fp32: each slot's denoise position
        sigma,          # (S,) fp32
        next_sigma,     # (S,) fp32
        embeddings,     # (2S, L, D): [positives; negatives]
        pooled,         # (2S, P)
        original_size,  # (2S, 2)
        target_size,    # (2S, 2)
        crop_coords,    # (2S, 2)
        cfg_scale,      # (S,) fp32: each request's guidance
        cfg_rescale,    # (S,) fp32
        seeds,          # (S,) host ints: each slot's base noise seed
        step_idx,       # (S,) host ints: each slot's step index
        active,         # (S,) bool: inactive rows keep their latents
        noise: Optional[torch.Tensor] = None,
    ):
        """One CFG Euler-ancestral step over a slot pool: every
        per-request scalar of ``_denoise_step`` is a per-slot vector, so
        requests at different steps (and with different guidance and step
        counts) share one batch. ``noise`` (S, h, w, c) fp32 replaces the
        draw of ``slot_noise(seeds, step_idx)``. Inactive rows compute and
        keep their latents."""
        expand = lambda v: v.view(-1, 1, 1, 1)
        if noise is None:
            noise = self.slot_noise(seeds, step_idx, latents.shape[1:], latents.device)
        sig2 = expand(torch.cat([sigma, sigma]).float())
        model_input = torch.cat([latents, latents]).float() / torch.sqrt(sig2 ** 2 + 1)
        model_input = model_input.to(latents.dtype)
        noise_pred = self.denoiser(
            model_input, torch.cat([timestep, timestep]).float(), embeddings, pooled,
            original_size, target_size, crop_coords,
        )
        positive, negative = noise_pred.float().chunk(2)
        noise_pred = _guidance(positive, negative, expand(cfg_scale.float()),
                               expand(cfg_rescale.float()))
        s, ns = expand(sigma.float()), expand(next_sigma.float())
        sigma_up = torch.sqrt(ns ** 2 * (s ** 2 - ns ** 2) / s ** 2)
        sigma_down = torch.sqrt(ns ** 2 - sigma_up ** 2)
        new_latents = latents.float() + noise_pred * (sigma_down - s) + noise.float() * sigma_up
        return torch.where(expand(active), new_latents.to(latents.dtype), latents)

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
        do_cfg = cfg_scale > 1.0
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(timesteps)
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.text_encoder, do_offloading, on):
            encoder_output = self.text_encoder.encode_prompts(
                prompt, negative_prompt, use_negative_prompts=do_cfg,
                max_token_length=max_token_length,
            )
        embeddings, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        return self._generate_core(
            embeddings, pooled, batch_size, height, width, original_size, target_size,
            crop_coords_top_left, timesteps, sigmas, cfg_scale, cfg_rescale, do_cfg, seed,
            deep_cache_interval, do_offloading,
        )

    def _generate_core(
        self, embeddings, pooled, batch_size, height, width, original_size, target_size,
        crop_coords_top_left, timesteps, sigmas, cfg_scale, cfg_rescale, do_cfg, seed,
        deep_cache_interval=None, do_offloading: bool = False,
    ) -> list[Image.Image]:
        """The seeded denoise loop and the decode, shared by ``generate()``
        and the context-level adapters (PFG, the style tokenizer), which
        differ only in how they make ``embeddings``. With ``do_offloading``
        the denoiser is on the card for the loop and the VAE for the decode,
        each parked on the host after it."""
        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.denoiser, do_offloading, on):
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
                cfg_scale, cfg_rescale, do_cfg, deep_cache_interval,
            )
        with stage_on_device(self.vae, do_offloading, on):
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


def _guidance(positive, negative, cfg_scale, cfg_rescale):
    """CFG with rescale (Lin et al. 2023, arXiv:2305.08891 sec. 3.4): the
    guided prediction's per-sample std re-matched to the positive branch's,
    blended by ``cfg_rescale`` (0 = off). fp32; scalars or per-sample
    (B, 1, 1, 1) tensors."""
    guided = negative + cfg_scale * (positive - negative)
    dims = tuple(range(1, guided.ndim))
    std_pos = positive.std(dim=dims, keepdim=True, correction=0)
    std_cfg = guided.std(dim=dims, keepdim=True, correction=0)
    rescaled = guided * (std_pos / std_cfg.clamp_min(1e-6))
    return cfg_rescale * rescaled + (1.0 - cfg_rescale) * guided
