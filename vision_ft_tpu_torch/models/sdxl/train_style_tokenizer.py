"""SDXL style tokenizer training (``vision_ft_tpu/models/sdxl/
train_style_tokenizer.py`` counterpart).

Both projectors train (the base model and the image encoder stay
frozen). Their style vectors, in fp32 and zeroed where the image is
dropped, are scattered into the two CLIP towers' input embeddings, so
the gradient flows back through both frozen towers; the VAE encode runs
without one. Epsilon-prediction loss with uniform or gaussian integer
timesteps. The reference image is the dataset's, converted to the
encoder's normalized NCHW batch.

``loss_fn`` draws, from the generator and in this order, the VAE
sample's noise, the timesteps and the noise; ``loss_with_draws`` is its
body for given draws.
"""

from __future__ import annotations

import os
from typing import Literal, Mapping

import torch
from PIL.Image import Image as PILImage

from ...config import TrainConfig
from ...modules.loss.diffusion import add_noise, loss_with_predicted_noise
from ..for_training import ModelForTraining
from .adapter.prompt_free import reference_from_dataset
from .adapter.style_tokenizer import (
    SDXLModelWithStyleTokenizer,
    SDXLModelWithStyleTokenizerConfig,
)
from .train_ip_adapter import draw_and_call, preview_with_reference
from .train_prompt_free import adapter_batch
from .train_text_to_image import _default_tokenizer


class SDXLModelWithStyleTokenizerTrainingConfig(SDXLModelWithStyleTokenizerConfig):
    max_token_length: int = 225
    drop_image_rate: float = 0.1

    freeze_vision_encoder: bool = True
    freeze_projector: bool = False

    timestep_sampling: Literal["uniform", "gaussian"] = "uniform"
    timestep_sampling_args: dict = {}


def loss_with_draws(
    model: SDXLModelWithStyleTokenizer,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """The loss for given draws: the VAE sample's noise, int timesteps
    (B,) and the noise. The style vectors of the batch's frozen
    ``reference_features`` reach the context through both towers, with
    their gradient."""
    dtype = model.dtype
    batch_size = batch["pixel_values"].shape[0]
    tokens_1, tokens_2 = model.project_style_tokens(batch["reference_features"].float())
    keep = (1.0 - batch["drop_image"])[:, None, None]
    emb1, emb2, pooled = model.text_encoder.encode_tokens_with_style(
        batch["input_ids"], batch_size,
        style_embeddings_1=(tokens_1 * keep).to(dtype),
        style_embeddings_2=(tokens_2 * keep).to(dtype),
    )
    context = torch.cat([emb1, emb2], dim=-1).to(dtype)
    pooled = pooled.to(dtype)
    with torch.no_grad():
        dist = model.vae.encode(batch["pixel_values"].to(dtype))
        latents = (dist.sample(None, vae_noise) * model.vae.scaling_factor).to(dtype)
    noisy_latents, random_noise = add_noise(latents, noise, timesteps)
    noise_pred = model.denoiser(
        noisy_latents, timesteps.float(), context, pooled, batch["original_size"],
        batch["target_size"], batch["crop_coords_top_left"],
    )
    return loss_with_predicted_noise(latents, random_noise, noise_pred)


class SDXLStyleTokenizerTraining(ModelForTraining):
    model: SDXLModelWithStyleTokenizer
    model_config: SDXLModelWithStyleTokenizerTrainingConfig
    model_config_class = SDXLModelWithStyleTokenizerTrainingConfig

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
        self.model = SDXLModelWithStyleTokenizer(
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
        if self.model_config.freeze_projector:
            return False
        return path.startswith(("projector_1.", "projector_2."))

    def sanity_check(self) -> None:
        dtype, device = self.model.dtype, self.device
        cfg = self.model.denoiser.config
        latent = torch.zeros((1, 12, 12, cfg.in_channels), dtype=dtype, device=device)
        with torch.no_grad():
            out = self.model.denoiser(
                latent, torch.tensor([50.0], device=device),
                torch.zeros((1, 77, cfg.context_dim), dtype=dtype, device=device),
                torch.zeros((1, 1280), dtype=dtype, device=device),
                torch.full((1, 2), 96.0, device=device), torch.full((1, 2), 96.0, device=device),
                torch.zeros((1, 2), device=device),
            )
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")

    # -- data --------------------------------------------------------------------------

    def preprocess_batch(self, batch: dict) -> dict:
        te = self.model.text_encoder
        acfg = self.model_config.adapter
        captions = [te.escape_exclamation(te.preprocess_style_token(c)) for c in batch["caption"]]
        reference = reference_from_dataset(batch["reference_image"], acfg.image_mean, acfg.image_std)
        return adapter_batch(self, batch, captions, reference)

    # -- loss ---------------------------------------------------------------------------------

    def loss_fn(self, batch, generator):
        return draw_and_call(self, batch, generator, loss_with_draws), {}

    # -- preview / saving ---------------------------------------------------------------------

    def preview_step(self, batch: dict, preview_index: int) -> list[PILImage]:
        return preview_with_reference(self, batch)

    def get_state_dict_to_save(self):
        return self.model.adapter_state_dict()

    def get_metadata_to_save(self) -> dict[str, str]:
        return {
            "projector_type": self.model_config.adapter.projector_type,
            "num_style_tokens": str(self.model_config.adapter.num_style_tokens),
            "style_token": self.model_config.adapter.style_token,
        }
