"""Wan 2.2 text-to-video pipeline (``vision_ft_tpu/models/wan/pipeline.py``
counterpart): the three-file checkpoint and flow-match Euler video
generation with CFG and optional DeepCache delta caching.

The denoiser and the text encoder are built on the meta device and
materialized by ``init_params`` (seeded random weights, on the device, in
the config's dtype) or ``from_checkpoint`` (the three safetensors files:
the denoiser in its ``model.``-prefixed keys, the text encoder and the
VAE in theirs; prequantized bnb / quanto weights are grouped into
quantized leaves). The VAE is any object of the ``vae.VAE`` protocol; the
default is the native causal 3-D VAE at its default config, fp32, which
``from_checkpoint`` fills from the VAE file and a caller of
``init_params`` fills with ``vae.init_random``.

The context is dense (B, Lc, D) with its masked positions zeroed, which
is what Wan's strip-then-zero-repad gives once the denoiser pads it to
``text_len``. ``generate(do_offloading=True)`` parks the text encoder and
the denoiser on the host between their stages, as the JAX package does
(``modules/offload.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from PIL import Image

from ...modules.offload import execution_device, stage_on_device
from ...nn import init_parameters_, load_flat_params
from ...utils import tensor as tensor_utils
from ...utils.dtype import str_to_dtype
from .config import WanConfig
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, TextEncoder, TextEncoderConfig
from .util import convert_from_original_key, convert_to_original_key
from .vae import VAE
from .vae3d import CausalVAE

_PARTS = ("denoiser", "text_encoder")


class Wan22:
    denoiser_class: type[Denoiser] = Denoiser
    text_encoder_class: type[TextEncoder] = TextEncoder
    vae_class: type[VAE] = CausalVAE

    def __init__(
        self,
        config: WanConfig,
        tokenizer=None,
        text_encoder_config: Optional[TextEncoderConfig] = None,
        vae: Optional[VAE] = None,
    ):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        if tokenizer is None:
            from ..text_encoders.auto_tokenizer import maybe_auto_tokenizer

            tokenizer = maybe_auto_tokenizer(config, family="t5")
        with torch.device("meta"):
            self.denoiser = self.denoiser_class(config.denoiser)
            self.text_encoder = self.text_encoder_class(config=text_encoder_config,
                                                        tokenizer=tokenizer)
            self.vae = vae if vae is not None else self.vae_class.from_default()
        self.scheduler = Scheduler()

    @classmethod
    def from_config(cls, config: WanConfig, **kwargs) -> "Wan22":
        return cls(config, **kwargs)

    def _parts(self) -> dict[str, torch.nn.Module]:
        return {name: getattr(self, name) for name in _PARTS}

    def as_module(self) -> torch.nn.ModuleDict:
        """The denoiser and the text encoder as one module (the same
        modules, not copies), keyed ``denoiser.*`` and ``text_encoder.*``;
        the VAE is its own object and loads from its own file."""
        return torch.nn.ModuleDict(self._parts())

    @property
    def device(self) -> torch.device:
        return self.denoiser.patch_embedding.weight.device

    # -- parameters and checkpoint I/O ------------------------------------------------

    def init_params(self, generator: torch.Generator, dtype: Optional[torch.dtype] = None,
                    device: Optional[torch.device] = None) -> None:
        """Seeded random weights of the denoiser and the text encoder, made
        on ``device`` (default: the generator's) in ``dtype`` (default: the
        config's), never through the host. The VAE is left as it is."""
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

    def _read(self, path: str, part: str, device: torch.device) -> dict[str, torch.Tensor]:
        """One file's tensors in internal keys, each read on its own and
        moved to ``device`` in this model's dtype (integers keep theirs)."""
        from safetensors import safe_open

        flat = {}
        with safe_open(str(path), framework="pt", device="cpu") as f:
            for key in f.keys():
                value = f.get_tensor(key)
                dtype = self.dtype if value.is_floating_point() else value.dtype
                flat[convert_from_original_key(key, part)] = value.to(device=device, dtype=dtype)
        return flat

    def _from_checkpoint(self, device: Optional[torch.device] = None) -> None:
        """Load the three files of the config onto ``device`` (default: the
        card), one part at a time."""
        from ...modules.quant import convert_prequantized_state_dict

        device = torch.device("cuda" if device is None else device)
        for name, path in (("denoiser", self.config.denoiser_path),
                           ("text_encoder", self.config.text_encoder_path)):
            part = getattr(self, name)
            flat = convert_prequantized_state_dict(self._read(path, name, device))
            part.to(dtype=self.dtype)
            load_flat_params(part, flat, meta_device=device)
            del flat
            part.to(device)
            part.eval()
        if hasattr(self.vae, "load_weights"):
            self.vae.load_weights(self._read(self.config.vae_path, "vae", device), device)

    @classmethod
    def from_checkpoint(cls, config: WanConfig, tokenizer=None,
                        device: Optional[torch.device] = None, **kwargs) -> "Wan22":
        """The model of ``config`` (``kwargs``: the constructor's
        ``text_encoder_config`` / ``vae``) loaded from its three files onto
        ``device`` (default: the card)."""
        model = cls(config, tokenizer=tokenizer, **kwargs)
        model._from_checkpoint(device)
        return model

    def denoiser_state_dict(self) -> dict[str, torch.Tensor]:
        return {convert_to_original_key(k, "denoiser"): v
                for k, v in self.denoiser.state_dict().items()}

    def text_encoder_state_dict(self) -> dict[str, torch.Tensor]:
        return {convert_to_original_key(k, "text_encoder"): v
                for k, v in self.text_encoder.state_dict().items()}

    # -- latents ----------------------------------------------------------------------

    def prepare_latents(self, batch_size: int, frames: int, height: int, width: int,
                        seed: Optional[int] = None) -> torch.Tensor:
        """NFHWC noise: ``frames // 4 * 4`` frames, then ``(f - 1) // 4 + 1``
        latent frames (the JAX package's arithmetic: 49 frames give 12
        latent frames, which decode to 45), 16x smaller in space."""
        tcr = self.vae.temporal_compression_ratio
        scr = self.vae.spatial_compression_ratio
        frames = frames // tcr * tcr
        shape = (batch_size, (frames - 1) // tcr + 1, height // scr, width // scr,
                 self.denoiser.config.in_channels)
        pf, ph, pw = self.denoiser.patch_size
        if shape[1] % pf or shape[2] % ph or shape[3] % pw:
            raise ValueError(
                f"latent grid {shape[1:4]} must be divisible by patch {self.denoiser.patch_size}")
        return tensor_utils.incremental_seed_randn(shape, seed, self.dtype, self.device)

    def encode_video(self, video) -> torch.Tensor:
        """A PIL image, a list of frames, a list of such lists or a (B, F,
        H, W, 3) tensor in [-1, 1] -> normalized latents."""
        if isinstance(video, Image.Image):
            video = [[video]]
        elif isinstance(video, (list, tuple)) and isinstance(video[0], Image.Image):
            video = [list(video)]
        if isinstance(video, (list, tuple)):
            video = tensor_utils.videos_to_tensor(list(video), self.dtype)
        return self.vae.normalize_latents(self.vae.encode(video))

    def decode_videos(self, latents: torch.Tensor) -> list[list[Image.Image]]:
        video = self.vae.decode(self.vae.denormalize_latents(latents))
        return tensor_utils.tensor_to_videos(video)

    # -- one step ---------------------------------------------------------------------

    def _denoise_step(
        self, latents, timestep, sigma, next_sigma, context, cfg_scale, cached_delta=None,
        do_cfg: bool = False, deep_cache: bool = False, refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """One flow-match Euler step ``latents + velocity * (next_sigma -
        sigma)`` in fp32, as in the JAX package; with ``deep_cache`` also
        returns the delta."""
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        t = torch.full((model_input.shape[0],), float(np.float32(timestep)),
                       dtype=torch.float32, device=latents.device)
        if deep_cache:
            velocity, delta = self.denoiser.deepcache_forward(
                model_input, t, context, cached_delta=cached_delta, refresh=refresh,
                cache_depth=cache_depth)
        else:
            velocity, delta = self.denoiser(model_input, t, context), None
        if do_cfg:
            positive, negative = velocity.float().chunk(2)
            velocity = negative + (positive - negative) * float(np.float32(cfg_scale))
        step = float(np.float32(next_sigma) - np.float32(sigma))
        new_latents = (latents.float() + velocity.float() * step).to(latents.dtype)
        return (new_latents, delta) if deep_cache else new_latents

    # -- generate ---------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        frames: int = 16,
        width: int = 768,
        height: int = 768,
        num_inference_steps: int = 25,
        cfg_scale: float = 5.0,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
        seed: Optional[int] = None,
        do_offloading: bool = False,
        deep_cache_interval: Optional[int] = None,
        deep_cache_depth: Optional[int] = None,
    ) -> list[list[Image.Image]]:
        """One list of frames a prompt."""
        do_cfg = cfg_scale > 1.0
        prompts = list(prompt) if isinstance(prompt, (list, tuple)) else [prompt]
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(num_inference_steps)

        on = execution_device(self) if do_offloading else None
        with stage_on_device(self.text_encoder, do_offloading, on):
            encoder_output = self.text_encoder.encode_prompts(
                prompts, negative_prompt, use_negative_prompts=do_cfg,
                max_token_length=max_token_length,
            )
        if do_cfg:
            embeddings = torch.cat([encoder_output.positive_embeddings,
                                    encoder_output.negative_embeddings])
            mask = torch.cat([encoder_output.positive_attention_mask,
                              encoder_output.negative_attention_mask])
        else:
            embeddings = encoder_output.positive_embeddings
            mask = encoder_output.positive_attention_mask
        # strip-then-zero-repad: masked positions become zero vectors
        context = (embeddings * mask[:, :, None].to(embeddings.dtype)).to(self.dtype)
        del encoder_output, embeddings

        with stage_on_device(self.denoiser, do_offloading, on):
            latents = self.prepare_latents(len(prompts), frames, height, width, seed=seed)
            cached_delta = None
            for i, t in enumerate(timesteps):
                step_args = (latents, t, sigmas[i], sigmas[i + 1], context, cfg_scale)
                if deep_cache_interval:
                    refresh = (i % deep_cache_interval == 0) or cached_delta is None
                    latents, cached_delta = self._denoise_step(
                        *step_args, None if refresh else cached_delta, do_cfg=do_cfg,
                        deep_cache=True, refresh=refresh, cache_depth=deep_cache_depth,
                    )
                else:
                    latents = self._denoise_step(*step_args, do_cfg=do_cfg)
            del context, cached_delta
        return self.decode_videos(latents)
