"""AuraFlow text-to-image pipeline (``vision_ft_tpu/models/auraflow/
pipeline.py`` counterpart): ``AuraFlowModel.generate()`` with CFG and
optional DeepCache delta caching (``deep_cache_interval``; see
``MMDiT.deepcache_forward``), and single-file checkpoint I/O.

``generate()`` encodes the prompts with UMT5, runs the flow-match Euler
loop over the MMDiT (the timestep fed to the denoiser is sigma, in the
latents' dtype, as in the JAX package; NHWC latents) and decodes the
latents with the SDXL KL-VAE into PIL images.

The modules are built on the meta device and materialized by
``init_params`` (seeded random weights, on the device, in the target
dtype), ``load_state_dict`` (the JAX package's flat parameters) or
``from_checkpoint`` (a single-file safetensors checkpoint in the original
key layout: ``model.*``, ``text_encoders.pile_t5xl.transformer.*`` and
``vae.*``; the UMT5 ``shared`` / ``encoder.embed_tokens`` pair may hold
only one of the two, the VAE may come in sgm or diffusers names, and
prequantized bnb / quanto weights are grouped into quantized leaves).
``state_dict()`` writes that layout back.

``_slot_step`` is the continuous-batching unit (``serving/continuous.py``):
one flow-match Euler step over a pool of slots with per-slot plain CFG.
``generate(do_offloading=True)`` parks the text encoder, denoiser and VAE
on the host between their stages (``modules/offload.py``).
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
from ..sdxl.util import vae_convert_from_original_key
from .config import AuraFlowConig
from .denoiser import Denoiser
from .scheduler import Scheduler
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH, TextEncoder
from .util import convert_from_original_key, convert_to_original_key
from .vae import DEFAULT_VAE_CONFIG, detect_vae_type

_PARTS = ("denoiser", "vae", "text_encoder")
# UMT5 ties its input embedding to the shared one; a checkpoint may hold either
_TIED = ("text_encoder.model.shared.weight", "text_encoder.model.encoder.embed_tokens.weight")


class AuraFlowModel:
    denoiser_class: type[Denoiser] = Denoiser
    # denoiser leaves a base checkpoint lacks (a workload's own modules: the
    # shortcut embedder, the migration scale): loaded as zeros where the
    # file has none; the workload sets them up after the load
    optional_denoiser_prefixes: tuple[str, ...] = ()

    def __init__(
        self,
        config: AuraFlowConig,
        tokenizer=None,
        vae_config=None,
        text_encoder_config=None,
    ):
        self.config = config
        self.dtype = str_to_dtype(config.dtype)
        if tokenizer is None:
            from ..text_encoders.auto_tokenizer import maybe_auto_tokenizer

            tokenizer = maybe_auto_tokenizer(config, family="t5")
        with torch.device("meta"):
            self.denoiser = self.denoiser_class.from_config(config.denoiser)
            self.vae = AutoencoderKL(vae_config or DEFAULT_VAE_CONFIG)
            self.text_encoder = TextEncoder(config=text_encoder_config, tokenizer=tokenizer)
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
        return self.denoiser.init_x_linear.weight.device

    # -- parameters ------------------------------------------------------------

    def init_params(
        self,
        generator: torch.Generator,
        dtype: Optional[torch.dtype] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        """Seeded random weights, made on ``device`` (default: the
        generator's) in ``dtype`` (default: the config's), never through
        the host; UMT5's input embedding equals the shared one, as the JAX
        package's init makes them."""
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
        self.text_encoder.model.tie_embeddings()

    def load_state_dict(
        self, flat: dict[str, np.ndarray], device: Optional[torch.device] = None
    ) -> None:
        """Load a flat internal-key state dict (``denoiser.*``, ``vae.*``,
        ``text_encoder.*``, as the JAX ``AuraFlowModel.load_state_dict``
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
            shared, embed = _TIED
            if shared not in names and embed in names:
                names[shared] = names[embed]
            elif embed not in names and shared in names:
                names[embed] = names[shared]
            if any(k.startswith("vae.") for k in names) and detect_vae_type(names) == "original":
                names = {
                    (vae_convert_from_original_key(k) if k.startswith("vae.") else k): v
                    for k, v in names.items()
                }
            for name, part in self._parts().items():
                prefix = name + "."
                flat = {}
                for key, original in names.items():
                    if key.startswith(prefix):
                        value = f.get_tensor(original)
                        dtype = self.dtype if value.is_floating_point() else value.dtype
                        flat[key[len(prefix):]] = value.to(device=device, dtype=dtype)
                if name == "denoiser":
                    for key, leaf in part.state_dict().items():
                        if key not in flat and key.startswith(self.optional_denoiser_prefixes):
                            flat[key] = torch.zeros(leaf.shape, dtype=self.dtype, device=device)
                part.to(dtype=self.dtype)
                load_flat_params(part, convert_prequantized_state_dict(flat), meta_device=device)
                del flat
                part.to(device)
                part.eval()

    @classmethod
    def from_original_checkpoint(
        cls, config: AuraFlowConig, tokenizer=None, device: Optional[torch.device] = None,
        **kwargs,
    ) -> "AuraFlowModel":
        """The model of ``config`` (``kwargs``: the constructor's
        ``vae_config`` / ``text_encoder_config``) loaded from
        ``config.checkpoint_path`` onto ``device`` (default: the card)."""
        model = cls(config, tokenizer=tokenizer, **kwargs)
        model._from_checkpoint(device)
        return model

    from_checkpoint = from_original_checkpoint  # the name the other pipelines use

    def state_dict(self) -> dict[str, torch.Tensor]:
        """Flat dict in the original single-file key layout, the tensors as
        the modules hold them (on their device)."""
        return {
            convert_to_original_key(f"{name}.{k}"): v
            for name, part in self._parts().items() for k, v in part.state_dict().items()
        }

    # -- latents / images --------------------------------------------------------

    def prepare_latents(
        self,
        batch_size: int,
        height: int,
        width: int,
        seed: Optional[int] = None,
        latents: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if latents is not None:
            return latents.to(self.device, self.dtype)
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
        return z * self.vae.scaling_factor

    def decode_image(self, latents: torch.Tensor) -> list[Image.Image]:
        return tensor_utils.tensor_to_images(self.vae.decode(latents / self.vae.scaling_factor))

    # -- one step ------------------------------------------------------------------

    def _denoise_step(
        self,
        latents,
        sigma,
        sigma_next,
        embeddings,
        cfg_scale,
        cached_delta=None,
        do_cfg: bool = False,
        deep_cache: bool = False,
        refresh: bool = True,
        cache_depth: Optional[int] = None,
    ):
        """One flow-match Euler step; with ``deep_cache`` also returns the
        delta. As in the JAX package: the timestep is sigma in the
        latents' dtype, the guidance and the update run in fp32 (its fp32
        scalars promote them), the difference of the two halves is taken
        in the model's dtype first."""
        sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
        model_input = torch.cat([latents, latents]) if do_cfg else latents
        timestep = torch.full(
            (model_input.shape[0],), float(sigma), dtype=torch.float32, device=latents.device
        ).to(latents.dtype)
        if deep_cache:
            velocity, delta = self.denoiser.deepcache_forward(
                model_input, embeddings, timestep, cached_delta=cached_delta, refresh=refresh,
                cache_depth=cache_depth,
            )
        else:
            velocity, delta = self.denoiser(model_input, embeddings, timestep), None
        if do_cfg:
            positive, negative = velocity.chunk(2)
            velocity = negative.float() + float(np.float32(cfg_scale)) * (positive - negative).float()
        new_latents = latents.float() + float(sigma_next - sigma) * velocity.float()
        new_latents = new_latents.to(latents.dtype)
        return (new_latents, delta) if deep_cache else new_latents

    def _slot_step(
        self,
        latents,     # (S, h, w, c): one row a serving slot
        timestep,    # (S,) fp32: unused (the model's time is sigma)
        sigma,       # (S,) fp32
        next_sigma,  # (S,) fp32
        embeddings,  # (2S, L, D): [positives; negatives]
        cfg_scale,   # (S,) fp32
        active,      # (S,) bool: inactive rows keep their latents
    ):
        """One flow-match Euler step over a slot pool with plain CFG, each
        request's scalars a per-slot vector; a slot with ``cfg_scale <= 1``
        takes the positive velocity (its negative half still computes, for
        one shape). The arithmetic is ``_denoise_step``'s."""
        s = latents.shape[0]
        expand = lambda v: v.view(-1, 1, 1, 1)
        t2 = torch.cat([sigma, sigma]).float().to(latents.dtype)
        velocity = self.denoiser(torch.cat([latents, latents]), embeddings, t2)
        positive, negative = velocity[:s], velocity[s:]
        guided = negative.float() + expand(cfg_scale.float()) * (positive - negative).float()
        velocity = torch.where(expand(cfg_scale > 1.0), guided, positive.float())
        new_latents = latents.float() + expand((next_sigma - sigma).float()) * velocity
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
        seed: Optional[int] = None,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
        do_offloading: bool = False,
        deep_cache_interval: Optional[int] = None,
        deep_cache_depth: Optional[int] = None,
    ) -> list[Image.Image]:
        do_cfg = cfg_scale > 1.0
        timesteps, sigmas = self.scheduler.schedule_tables(num_inference_steps)
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1

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

            cached_delta = None
            for i in range(len(timesteps)):
                step_args = (latents, sigmas[i], sigmas[i + 1], embeddings, cfg_scale)
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
