"""SDXL text-to-image training (``vision_ft_tpu/models/sdxl/
train_text_to_image.py`` counterpart): the ``ModelForTraining`` subclass
and the body of its loss.

Epsilon-prediction DDPM loss with uniform integer timesteps and frozen
text encoders and VAE: the conditioning comes from the batch's caches
(``cached_context`` / ``cached_pooled``, ``cached_latents``) or, under
``no_grad``, from ``encode_tokens`` and from a VAE ``encode`` sample of the
batch's ``pixel_values``. Optional Min-SNR weighting.

:class:`SDXLForTextToImageTraining` adds what the Trainer calls: the model
from ``checkpoint_path`` when that file exists (seeded random weights
otherwise; the tokenizer passed in, else the one in ``CLIP_VOCAB_DIR``,
else the pipeline's lookup), gradient checkpointing, the sanity check, tokenizing in
``preprocess_batch``, the content-hash caches of latents (the VAE's mode)
and of text embeddings, previews through ``generate()`` and the saved
state: the whole model, or under PEFT the adapters in ComfyUI keys.
"""

from __future__ import annotations

import hashlib
import os
from typing import Mapping, Optional

import numpy as np
import torch
from PIL.Image import Image

from ...modules.long_prompt import tokenize_long_prompt
from ...modules.loss.diffusion import (
    add_noise,
    loss_with_predicted_noise,
    min_snr_weighted_loss,
)
from ...modules.peft import get_adapter_parameters
from ...modules.timestep.sampling import uniform_randint
from ..for_training import ModelForTraining
from .config import SDXLConfig
from .pipeline import SDXLModel
from .text_encoder import CHUNK_LENGTH
from .util import convert_to_comfy_key


class SDXLForTextToImageTrainingConfig(SDXLConfig):
    max_token_length: int = 225  # 75 * 3

    # content-hash caches of the frozen encoders' outputs, filled on first
    # sight and reused across epochs and repeats: latents from the VAE's
    # mode(), text embeddings keyed on the caption string
    cache_latents: bool = False
    cache_text_embeddings: bool = False

    # Min-SNR-gamma loss weighting; None = plain epsilon MSE
    min_snr_gamma: Optional[float] = None


def conditioning(
    model: SDXLModel,
    batch: Mapping[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    vae_noise: Optional[torch.Tensor] = None,
):
    """(latents, context, pooled) of a batch in the model's dtype, with no
    gradient path into the frozen encoders. Without ``cached_latents`` the
    latents are a sample of the VAE's posterior over ``pixel_values``, its
    noise drawn from ``generator`` or given as ``vae_noise``."""
    dtype = model.dtype
    with torch.no_grad():
        if "cached_context" in batch:
            context = batch["cached_context"].to(dtype)
            pooled = batch["cached_pooled"].to(dtype)
        else:
            batch_size = batch["original_size"].shape[0]
            emb1, emb2, pooled = model.text_encoder.encode_tokens(
                batch["input_ids"], batch["input_ids"], batch_size
            )
            context = torch.cat([emb1, emb2], dim=-1).to(dtype)
            pooled = pooled.to(dtype)
        if "cached_latents" in batch:
            latents = batch["cached_latents"].to(dtype)
        else:
            dist = model.vae.encode(batch["pixel_values"].to(dtype))
            latents = (dist.sample(generator, vae_noise) * model.vae.scaling_factor).to(dtype)
    return latents, context, pooled


def loss_with_draws(
    model: SDXLModel,
    batch: Mapping[str, torch.Tensor],
    timesteps: torch.Tensor,
    random_noise: torch.Tensor,
    min_snr_gamma: Optional[float] = None,
    vae_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The loss for given draws: int timesteps (B,), fp32 noise of the
    latents' shape and, without cached latents, the VAE sample's noise.
    Noising, denoiser, plain or Min-SNR-weighted MSE."""
    latents, context, pooled = conditioning(model, batch, vae_noise=vae_noise)
    noisy_latents, random_noise = add_noise(latents, random_noise, timesteps)
    noise_pred = model.denoiser(
        noisy_latents,
        timesteps.float(),
        context,
        pooled,
        batch["original_size"],
        batch["target_size"],
        batch["crop_coords_top_left"],
    )
    if min_snr_gamma is not None:
        return min_snr_weighted_loss(
            latents, random_noise, noise_pred, timesteps, gamma=min_snr_gamma
        )
    return loss_with_predicted_noise(latents, random_noise, noise_pred)


def _latent_shape(model: SDXLModel, batch: Mapping[str, torch.Tensor]) -> tuple[int, ...]:
    if "cached_latents" in batch:
        return tuple(batch["cached_latents"].shape)
    b, h, w, _ = batch["pixel_values"].shape
    ratio = int(model.vae.compression_ratio)
    return (b, h // ratio, w // ratio, model.vae.config.latent_channels)


def loss_fn(
    model: SDXLModel,
    batch: Mapping[str, torch.Tensor],
    generator: torch.Generator,
    min_snr_gamma: Optional[float] = None,
):
    """``(loss, metrics)`` of one batch: the VAE sample's noise (without
    cached latents), the timesteps (uniform integers in [0, 1000)) and the
    noise (unit normal) are drawn from ``generator``, in that order."""
    shape = _latent_shape(model, batch)
    device = batch["original_size"].device
    vae_noise = None
    if "cached_latents" not in batch:
        vae_noise = torch.randn(
            shape, generator=generator, dtype=torch.float32, device=generator.device
        ).to(device)
    timesteps = uniform_randint(generator, shape, 0, 1000).to(device)
    random_noise = torch.randn(
        shape, generator=generator, dtype=torch.float32, device=generator.device
    ).to(device)
    loss = loss_with_draws(model, batch, timesteps, random_noise, min_snr_gamma, vae_noise)
    return loss, {}


def _default_tokenizer():
    """The CLIP BPE tokenizer of ``CLIP_VOCAB_DIR`` (``vocab.json`` +
    ``merges.txt``) where that variable names a directory, else None."""
    vocab_dir = os.environ.get("CLIP_VOCAB_DIR")
    if vocab_dir and os.path.isdir(vocab_dir):
        from ..text_encoders.tokenizer import CLIPTokenizer

        return CLIPTokenizer.from_pretrained_dir(vocab_dir)
    return None


class SDXLForTextToImageTraining(ModelForTraining):
    model: SDXLModel
    model_config: SDXLForTextToImageTrainingConfig
    model_config_class = SDXLForTextToImageTrainingConfig

    def __init__(self, trainer, config, tokenizer=None) -> None:
        self.tokenizer = tokenizer
        self._latent_cache: dict = {}
        self._text_cache: dict = {}
        super().__init__(trainer, config)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def before_setup_model(self) -> None:
        pass

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        if os.path.exists(self.model_config.checkpoint_path):
            self.model = SDXLModel.from_checkpoint(
                self.model_config, tokenizer=tokenizer, device=self.device
            )
        else:
            # no checkpoint (tests / from scratch): seeded random weights
            self.model = SDXLModel(self.model_config, tokenizer=tokenizer)
            self.model.init_params(
                torch.Generator(device=self.device).manual_seed(self.config.seed)
            )

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def sanity_check(self) -> None:
        denoiser = self.model.denoiser
        dtype, device = self.model.dtype, self.device
        latent = torch.zeros((1, 12, 12, denoiser.config.in_channels), dtype=dtype, device=device)
        with torch.no_grad():
            out = denoiser(
                latent,
                torch.tensor([50.0], device=device),
                torch.zeros((1, 77, denoiser.config.context_dim), dtype=dtype, device=device),
                torch.zeros((1, 1280), dtype=dtype, device=device),
                torch.full((1, 2), 96.0, device=device),
                torch.full((1, 2), 96.0, device=device),
                torch.zeros((1, 2), device=device),
            )
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")

    # -- frozen-encoder caches ------------------------------------------------------

    @torch.no_grad()
    def _cached_latents(self, pixel_values: np.ndarray) -> np.ndarray:
        keys = [hashlib.blake2b(row.tobytes(), digest_size=16).digest() for row in pixel_values]
        missing = [i for i, k in enumerate(keys) if k not in self._latent_cache]
        if missing:
            model = self.model
            pixels = torch.from_numpy(pixel_values[missing]).to(self.device, model.dtype)
            encoded = (model.vae.encode(pixels).mode() * model.vae.scaling_factor).to(model.dtype)
            encoded = encoded.float().cpu().numpy()
            for j, i in enumerate(missing):
                self._latent_cache[keys[i]] = encoded[j]
        return np.stack([self._latent_cache[k] for k in keys])

    @torch.no_grad()
    def _cached_text_embeddings(self, captions: list[str], ids: np.ndarray):
        batch = len(captions)
        cache_keys = [(c, self.model_config.max_token_length) for c in captions]
        missing = [i for i, k in enumerate(cache_keys) if k not in self._text_cache]
        if missing:
            # encode the whole batch once; store every row
            model = self.model
            input_ids = torch.from_numpy(np.asarray(ids)).to(self.device)
            emb1, emb2, pooled = model.text_encoder.encode_tokens(input_ids, input_ids, batch)
            ctx = torch.cat([emb1, emb2], dim=-1).to(model.dtype).float().cpu().numpy()
            pooled = pooled.to(model.dtype).float().cpu().numpy()
            for i in range(batch):
                self._text_cache[cache_keys[i]] = (ctx[i], pooled[i])
        rows = [self._text_cache[k] for k in cache_keys]
        return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])

    def preprocess_batch(self, batch: dict) -> dict:
        cfg = self.model_config
        captions = [self.model.text_encoder.escape_exclamation(c) for c in batch["caption"]]
        tokenizer = self.model.text_encoder.tokenizer
        if tokenizer is None:
            raise RuntimeError("No tokenizer configured for training")
        ids, _mask = tokenize_long_prompt(
            tokenizer, captions, max_length=cfg.max_token_length, chunk_length=CHUNK_LENGTH
        )
        ids = np.asarray(ids)
        pixel_values = np.asarray(batch["image"], np.float32)
        out = {
            "original_size": np.asarray(batch["original_size"], np.float32),
            "target_size": np.asarray(batch["target_size"], np.float32),
            "crop_coords_top_left": np.asarray(batch["crop_coords_top_left"], np.float32),
        }
        # workloads whose config has no caches (flow match, RoPE distillation)
        if getattr(cfg, "cache_latents", False):
            out["cached_latents"] = self._cached_latents(pixel_values)
        else:
            out["pixel_values"] = pixel_values
        if getattr(cfg, "cache_text_embeddings", False):
            out["cached_context"], out["cached_pooled"] = self._cached_text_embeddings(captions, ids)
        else:
            out["input_ids"] = ids
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}

    # -- loss --------------------------------------------------------------------------

    def loss_fn(self, batch, generator):
        return loss_fn(self.model, batch, generator, self.model_config.min_snr_gamma)

    # -- preview / saving ----------------------------------------------------------------

    def preview_step(self, batch: dict, preview_index: int) -> list[Image]:
        negative_prompt = batch["negative_prompt"]
        if negative_prompt is None and batch["cfg_scale"] > 0:
            negative_prompt = ""
        image = self.model.generate(
            prompt=batch["prompt"],
            negative_prompt=negative_prompt,
            height=batch["height"],
            width=batch["width"],
            cfg_scale=batch["cfg_scale"],
            num_inference_steps=batch["num_steps"],
            seed=batch["seed"],
            max_token_length=self.model_config.max_token_length,
        )[0]
        return [image]

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
