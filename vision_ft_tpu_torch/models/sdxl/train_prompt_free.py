"""SDXL Prompt-Free Generation (PFG) training (``vision_ft_tpu/models/
sdxl/train_prompt_free.py`` counterpart).

- reference-image mode (:class:`SDXLPFGTraining`): the dataset's paired
  reference image;
- self-reference mode (:class:`SDXLPFGSelfTraining`): the target image is
  its own reference.

The projector's tokens ride the text context's tail, zeroed on rows where
the image is dropped (a host draw from numpy's global generator, rate
``drop_image_rate``). The projector trains, in the model's dtype; the
UNet trains only through LoRA when ``config.peft`` is set, and the
projector trains beside it then too (the JAX package's PEFT split leaves
it frozen, ROADMAP section 3). The frozen image encoder runs in
``preprocess_batch`` on the model's device, on the normalized NCHW batch
(a dataset reference in [-1, 1] NHWC is converted to it).

``loss_fn`` draws, from the generator and in this order, the VAE
sample's noise, the timesteps and the noise; ``loss_with_draws`` is its
body for given draws.
"""

from __future__ import annotations

import os
from typing import Literal, Mapping

import numpy as np
import torch
from PIL import Image
from PIL.Image import Image as PILImage

from ...config import TrainConfig
from ...modules.long_prompt import tokenize_long_prompt
from ...modules.loss.diffusion import add_noise, loss_with_predicted_noise
from ...modules.peft import get_adapter_parameters
from ..for_training import ModelForTraining
from .adapter.prompt_free import SDXLModelWithPFG, SDXLModelWithPFGConfig, reference_from_dataset
from .text_encoder import CHUNK_LENGTH
from .train_ip_adapter import draw_and_call, preview_with_reference
from .train_text_to_image import _default_tokenizer, conditioning
from .util import convert_to_comfy_key


class SDXLModelWithPFGTrainingConfig(SDXLModelWithPFGConfig):
    max_token_length: int = 75
    drop_image_rate: float = 0.1

    freeze_vision_encoder: bool = True

    timestep_sampling: Literal["uniform", "gaussian"] = "uniform"
    timestep_sampling_args: dict = {}


def loss_with_draws(
    model: SDXLModelWithPFG,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """The loss for given draws: the VAE sample's noise, int timesteps
    (B,) and the noise. The projector maps the batch's frozen
    ``reference_features`` in the model's dtype; its tokens, zeroed where
    ``drop_image``, are concatenated to the context."""
    dtype = model.dtype
    latents, context, pooled = conditioning(model, batch, vae_noise=vae_noise)
    image_tokens = model.projector(batch["reference_features"].to(dtype))
    image_tokens = image_tokens * (1.0 - batch["drop_image"])[:, None, None]
    context = torch.cat([context, image_tokens.to(dtype)], dim=1)
    noisy_latents, random_noise = add_noise(latents, noise, timesteps)
    noise_pred = model.denoiser(
        noisy_latents, timesteps.float(), context, pooled, batch["original_size"],
        batch["target_size"], batch["crop_coords_top_left"],
    )
    return loss_with_predicted_noise(latents, random_noise, noise_pred)


def adapter_batch(workload, batch: dict, captions: list[str], reference: np.ndarray) -> dict:
    """The loss's tensors on the workload's device: the captions' ids, the
    pixels, the size conditioning, the image drop (numpy's global
    generator at ``drop_image_rate``) and the frozen encoder's fp32
    features of the normalized NCHW ``reference`` batch."""
    cfg = workload.model_config
    ids, _ = tokenize_long_prompt(workload.model.text_encoder.tokenizer, captions,
                                  max_length=cfg.max_token_length, chunk_length=CHUNK_LENGTH)
    pixel_values = np.asarray(batch["image"], np.float32)
    drop_image = np.random.rand(pixel_values.shape[0]) < cfg.drop_image_rate
    out = {
        "pixel_values": pixel_values,
        "input_ids": np.asarray(ids),
        "original_size": np.asarray(batch["original_size"], np.float32),
        "target_size": np.asarray(batch["target_size"], np.float32),
        "crop_coords_top_left": np.asarray(batch["crop_coords_top_left"], np.float32),
        "drop_image": drop_image.astype(np.float32),
    }
    out = {k: torch.from_numpy(v).to(workload.device) for k, v in out.items()}
    with torch.no_grad():
        out["reference_features"] = workload.model.encode_image_features(
            torch.from_numpy(reference).to(workload.device))
    return out


class SDXLPFGTraining(ModelForTraining):
    """Reference-image mode."""

    model: SDXLModelWithPFG
    model_config: SDXLModelWithPFGTrainingConfig
    model_config_class = SDXLModelWithPFGTrainingConfig

    self_reference: bool = False

    def __init__(self, trainer, config: TrainConfig, tokenizer=None, image_encoder=None):
        self.tokenizer = tokenizer
        self.image_encoder = image_encoder
        super().__init__(trainer, config)

    @property
    def device(self) -> torch.device:
        return self.trainer.device

    def before_setup_model(self) -> None:
        pass

    def setup_model(self) -> None:
        tokenizer = self.tokenizer or _default_tokenizer()
        self.model = SDXLModelWithPFG(
            self.model_config, image_encoder=self.image_encoder, tokenizer=tokenizer
        )
        if os.path.exists(self.model_config.checkpoint_path):
            self.model._from_checkpoint(self.device)
        else:
            self.model.init_params(torch.Generator(device=self.device).manual_seed(self.config.seed))

    def after_setup_model(self) -> None:
        if self.config.trainer.gradient_checkpointing:
            self.model.denoiser.set_gradient_checkpointing(True)

    def trainable_filter(self, path: str) -> bool:
        return path.startswith("projector.")

    def peft_extra_trainable_filter(self, path: str) -> bool:
        return path.startswith("projector.")

    def sanity_check(self) -> None:
        dtype, device = self.model.dtype, self.device
        cfg = self.model.denoiser.config
        n_tok = self.model_config.adapter.num_image_tokens
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
        if self.self_reference:
            images = [Image.fromarray(((np.clip(im, -1, 1) + 1) / 2 * 255).astype(np.uint8))
                      for im in np.asarray(batch["image"], np.float32)]
            reference = self.model.preprocess_reference_image(images)
        else:
            acfg = self.model_config.adapter
            reference = reference_from_dataset(batch["reference_image"], acfg.image_mean,
                                               acfg.image_std)
        captions = [self.model.text_encoder.escape_exclamation(c) for c in batch["caption"]]
        return adapter_batch(self, batch, captions, reference)

    # -- loss ----------------------------------------------------------------------------

    def loss_fn(self, batch, generator):
        return draw_and_call(self, batch, generator, loss_with_draws), {}

    # -- preview / saving ------------------------------------------------------------------

    def preview_step(self, batch: dict, preview_index: int) -> list[PILImage]:
        return preview_with_reference(self, batch)

    def get_state_dict_to_save(self):
        state_dict = self.model.adapter_state_dict()
        if self._is_peft:
            peft = get_adapter_parameters(self.get_params())
            state_dict.update({convert_to_comfy_key(k): v for k, v in peft.items()})
        return state_dict

    def get_metadata_to_save(self) -> dict[str, str]:
        return {
            "projector_type": self.model_config.adapter.projector_type,
            "num_image_tokens": str(self.model_config.adapter.num_image_tokens),
        }


class SDXLPFGSelfTraining(SDXLPFGTraining):
    """Self-reference mode."""

    self_reference = True
