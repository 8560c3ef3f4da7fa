"""SDXL IP-Adapter training (``vision_ft_tpu/models/sdxl/
train_ip_adapter.py`` counterpart).

- reference-image mode (:class:`SDXLIPAdapterTraining`): ip tokens from a
  paired reference image, concatenated to the text context (the
  context-tail variants read them there); a random image drop for CFG;
  uniform or gaussian integer timesteps.
- self-reference mode (:class:`SDXLIPAdapterSelfTraining`): the target
  image is its own reference; ip tokens go through
  ``cross_attention_kwargs``, optionally cut to their first few (token
  tail-drop) with a key mask.
- kyara mode (:class:`SDXLIPAdapterKyaraTraining`): the dataset's cropped
  character references, tokens through ``cross_attention_kwargs`` with the
  tail-drop.

The adapter projections (with their gates and norms) and the image
projector train; the UNet, the text encoders, the VAE and the image
encoder are frozen. The frozen image encoder runs in ``preprocess_batch``
on the model's device, under ``no_grad``; only the projector runs inside
the loss. ``loss_fn`` draws, from the generator and in this order, the VAE
sample's noise, the timesteps and the noise; ``loss_with_draws`` is its
body for given draws. The image drop and the tail-drop are drawn on the
host from numpy's global generator, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Literal, Mapping, Optional

import numpy as np
import torch
from PIL import Image
from PIL.Image import Image as PILImage

from ...config import TrainConfig
from ...modules.long_prompt import tokenize_long_prompt
from ...modules.loss.diffusion import add_noise, loss_with_predicted_noise
from ...modules.timestep.sampling import gaussian_randint, uniform_randint
from ..for_training import ModelForTraining
from .adapter.ip_adapter import (
    VARIANT_CLASSES,
    SDXLModelWithIPAdapter,
    SDXLModelWithIPAdapterConfig,
)
from .text_encoder import CHUNK_LENGTH
from .train_text_to_image import _default_tokenizer

_ADAPTER_LEAVES = tuple(
    sorted({name for cls in VARIANT_CLASSES.values() for name in cls.adapter_param_names})
)


class SDXLModelWithIPAdapterTrainingConfig(SDXLModelWithIPAdapterConfig):
    max_token_length: int = 225

    timestep_sampling: Literal["uniform", "gaussian"] = "uniform"
    timestep_sampling_args: dict = {}

    drop_image_rate: float = 0.0

    # self-reference mode
    token_tail_drop: bool = False
    token_tail_drop_rate: float = 0.5
    token_tail_drop_sampling: Literal["uniform"] = "uniform"


def sample_timesteps(cfg, generator: torch.Generator, shape) -> torch.Tensor:
    args = cfg.timestep_sampling_args
    lo, hi = args.get("min_timesteps", 0), args.get("max_timesteps", 1000)
    if cfg.timestep_sampling == "uniform":
        return uniform_randint(generator, shape, lo, hi)
    return gaussian_randint(generator, shape, lo, hi, args.get("mean", 100), args.get("std", 100))


def draw_and_call(workload, batch, generator, loss_with_draws):
    """Draw the VAE sample's noise, the timesteps and the noise from
    ``generator``, in that order, and call ``loss_with_draws`` with them."""
    model = workload.model
    b, h, w, _ = batch["pixel_values"].shape
    ratio = int(model.vae.compression_ratio)
    shape = (b, h // ratio, w // ratio, model.vae.config.latent_channels)
    device = batch["pixel_values"].device

    def randn():
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device).to(device)

    vae_noise = randn()
    timesteps = sample_timesteps(workload.model_config, generator, shape).to(device)
    noise = randn()
    return loss_with_draws(model, batch, vae_noise, timesteps, noise)


def preview_with_reference(workload, batch: dict) -> list[PILImage]:
    """A preview through ``generate()``, with the preview item's
    ``reference_image_path`` as the reference where it names one."""
    negative_prompt = batch["negative_prompt"]
    if negative_prompt is None and batch["cfg_scale"] > 0:
        negative_prompt = ""
    reference = None
    if path := (batch.get("extra") or {}).get("reference_image_path"):
        reference = Image.open(path).convert("RGB")
    image = workload.model.generate(
        prompt=batch["prompt"], negative_prompt=negative_prompt, reference_image=reference,
        height=batch["height"], width=batch["width"], cfg_scale=batch["cfg_scale"],
        num_inference_steps=batch["num_steps"], seed=batch["seed"],
        max_token_length=workload.model_config.max_token_length,
    )[0]
    return [image]


def loss_with_draws(
    model: SDXLModelWithIPAdapter,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
    tokens_via_cross_attention: bool,
    tokens_to_keep: Optional[int] = None,
) -> torch.Tensor:
    """The loss for given draws: the VAE sample's noise, int timesteps
    (B,) and the noise. The projector maps the batch's frozen
    ``reference_features`` to ip tokens, zeroed on rows with
    ``drop_image``; they reach attn2 through ``cross_attention_kwargs``
    (cut to ``tokens_to_keep``, with a key mask) or on the context's tail."""
    dtype = model.dtype
    batch_size = batch["pixel_values"].shape[0]
    with torch.no_grad():
        emb1, emb2, pooled = model.text_encoder.encode_tokens(
            batch["input_ids"], batch["input_ids"], batch_size
        )
        context = torch.cat([emb1, emb2], dim=-1).to(dtype)
        pooled = pooled.to(dtype)
        dist = model.vae.encode(batch["pixel_values"].to(dtype))
        latents = (dist.sample(None, vae_noise) * model.vae.scaling_factor).to(dtype)

    features = batch["reference_features"].to(dtype)
    ip_tokens = model.image_proj(features, context)
    ip_tokens = ip_tokens * (1.0 - batch["drop_image"].to(ip_tokens.dtype))[:, None, None]

    cross_attention_kwargs = None
    if tokens_via_cross_attention:
        ip_mask = None
        if tokens_to_keep is not None:
            ip_tokens = ip_tokens[:, :tokens_to_keep, :]
            ip_mask = torch.ones((batch_size, tokens_to_keep), dtype=torch.bool,
                                 device=ip_tokens.device)
        cross_attention_kwargs = {"ip_tokens": ip_tokens, "ip_mask": ip_mask}
    else:
        context = torch.cat([context, ip_tokens], dim=1)

    noisy_latents, random_noise = add_noise(latents, noise, timesteps)
    noise_pred = model.denoiser(
        noisy_latents, timesteps.float(), context, pooled, batch["original_size"],
        batch["target_size"], batch["crop_coords_top_left"],
        cross_attention_kwargs=cross_attention_kwargs,
    )
    return loss_with_predicted_noise(latents, random_noise, noise_pred)


class SDXLIPAdapterTraining(ModelForTraining):
    """Reference-image mode."""

    model: SDXLModelWithIPAdapter
    model_config: SDXLModelWithIPAdapterTrainingConfig
    model_config_class = SDXLModelWithIPAdapterTrainingConfig

    self_reference: bool = False
    # ref mode rides the context tail; self / kyara modes pass the tokens
    # through cross_attention_kwargs (with the optional tail-drop)
    tokens_via_cross_attention: bool = False

    def __init__(self, trainer, config: TrainConfig, tokenizer=None, image_encoder=None):
        self.tokenizer = tokenizer
        self.image_encoder = image_encoder
        self._tokens_to_keep: Optional[int] = None
        super().__init__(trainer, config)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def before_setup_model(self) -> None:
        pass

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        self.model = SDXLModelWithIPAdapter(
            self.model_config, image_encoder=self.image_encoder, tokenizer=tokenizer
        )
        if os.path.exists(self.model_config.checkpoint_path):
            self.model._from_checkpoint(self.device)
        else:
            self.model.init_params(torch.Generator(device=self.device).manual_seed(self.config.seed))
        self.model.init_adapter_params(
            torch.Generator(device=self.device).manual_seed(self.config.seed + 1)
        )
        if self.model_config.adapter.checkpoint_weight:
            from ...utils import safetensors as st

            self.model.load_adapter_params(st.load_file(self.model_config.adapter.checkpoint_weight))

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def trainable_filter(self, path: str) -> bool:
        if path.startswith("image_proj."):
            return True
        # adapter leaves directly under an attn2 ("norm" and "gate" are
        # names elsewhere in the UNet too)
        parts = path.split(".")
        return any(
            i > 0 and parts[i - 1] == "attn2" and part in _ADAPTER_LEAVES
            for i, part in enumerate(parts)
        )

    def sanity_check(self) -> None:
        dtype, device = self.model.dtype, self.device
        cfg = self.model.denoiser.config
        n_tok = self.model_config.adapter.num_ip_tokens
        latent = torch.zeros((1, 12, 12, cfg.in_channels), dtype=dtype, device=device)
        with torch.no_grad():
            out = self.model.denoiser(
                latent, torch.tensor([50.0], device=device),
                torch.zeros((1, 77 + n_tok, cfg.context_dim), dtype=dtype, device=device),
                torch.zeros((1, 1280), dtype=dtype, device=device),
                torch.full((1, 2), 96.0, device=device), torch.full((1, 2), 96.0, device=device),
                torch.zeros((1, 2), device=device),
            )
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")

    # -- data ------------------------------------------------------------------------

    def preprocess_batch(self, batch: dict) -> dict:
        model = self.model
        captions = [model.text_encoder.escape_exclamation(c) for c in batch["caption"]]
        ids, _ = tokenize_long_prompt(
            model.text_encoder.tokenizer, captions,
            max_length=self.model_config.max_token_length, chunk_length=CHUNK_LENGTH,
        )
        pixel_values = np.asarray(batch["image"], np.float32)
        if self.self_reference:
            images = [
                Image.fromarray(((np.clip(im, -1, 1) + 1) / 2 * 255).astype(np.uint8))
                for im in pixel_values
            ]
            reference = model.preprocess_reference_image(images)
        else:
            reference = np.asarray(batch["reference_image"], np.float32)

        batch_size = pixel_values.shape[0]
        drop_image = (np.random.rand(batch_size) < self.model_config.drop_image_rate).astype(np.float32)
        out = {
            "pixel_values": pixel_values,
            "input_ids": np.asarray(ids),
            "original_size": np.asarray(batch["original_size"], np.float32),
            "target_size": np.asarray(batch["target_size"], np.float32),
            "crop_coords_top_left": np.asarray(batch["crop_coords_top_left"], np.float32),
            "drop_image": drop_image,
        }
        out = {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}
        # the frozen encoder on the model's device: its features stay there
        with torch.no_grad():
            out["reference_features"] = torch.as_tensor(
                model.encoder(torch.from_numpy(reference).to(self.device))
            ).to(self.device)

        self._tokens_to_keep = None
        if self.tokens_via_cross_attention and self.model_config.token_tail_drop:
            if np.random.rand() < self.model_config.token_tail_drop_rate:
                self._tokens_to_keep = int(
                    np.random.randint(1, self.model_config.adapter.num_ip_tokens + 1)
                )
        return out

    # -- loss -------------------------------------------------------------------------

    def loss_fn(self, batch, generator):
        loss = functools.partial(loss_with_draws,
                                 tokens_via_cross_attention=self.tokens_via_cross_attention,
                                 tokens_to_keep=self._tokens_to_keep)
        return draw_and_call(self, batch, generator, loss), {}

    # -- preview / saving ----------------------------------------------------------------

    def preview_step(self, batch: dict, preview_index: int) -> list[PILImage]:
        return preview_with_reference(self, batch)

    def get_state_dict_to_save(self):
        return self.model.get_adapter_state_dict()

    def get_metadata_to_save(self) -> dict[str, str]:
        return {
            "projector_type": self.model_config.adapter.projector_type,
            "variant": self.model_config.adapter.variant,
            "num_ip_tokens": str(self.model_config.adapter.num_ip_tokens),
        }


class SDXLIPAdapterSelfTraining(SDXLIPAdapterTraining):
    """Self-reference mode."""

    self_reference = True
    tokens_via_cross_attention = True


class SDXLIPAdapterKyaraTraining(SDXLIPAdapterTraining):
    """Kyara mode: the dataset's cropped character references (already
    normalized by the Kyara dataset), tokens through
    ``cross_attention_kwargs`` with the tail-drop, no image drop unless
    configured."""

    self_reference = False
    tokens_via_cross_attention = True
