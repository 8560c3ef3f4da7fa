"""AuraFlow VAE-encoder migration training workload
(``vision_ft_tpu/models/auraflow/train_vae_encode_migration.py``
counterpart).

It migrates the MMDiT's patch input from the 4-channel AuraFlow (SDXL) VAE
to the 16-channel Flux VAE. ``init_x_linear`` grows zero input columns
(4 ch * p * p -> 16 ch * p * p); old-VAE patches are zero-padded to the
new width, so both encode paths feed the same projection; a per-feature
:class:`MigrationScaleFromZero` blends them:

    mixed = (1 - s) * sg(aura_patches) + s * flux_patches
    loss  = MSE(aura_patches, mixed) + MSE(s, 1)

Only the migration scale trains. Both VAEs are drawn from the seed in fp32,
as the JAX workload draws them (its ``flux_vae_repo_name`` names weights it
never downloads), and run under ``no_grad``; only ``init_x_linear`` is read
from ``checkpoint_path`` where that file exists. The workload has no
pipeline: its parameters are one ``nn.ModuleDict`` keyed ``aura_vae.*``,
``flux_vae.*``, ``denoiser.init_x_linear.*`` and ``migration_scale.*``.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...modules.migration.scale import MigrationScaleFromZero
from ...modules.patch import patchify
from ...modules.peft import get_adapter_parameters
from ...nn import Linear, init_parameters_, load_flat_params
from ..autoencoder import AutoencoderKL
from ..autoencoder.kl import FLUX_VAE_CONFIG
from .config import AuraFlowConig
from .train_text_to_image import AuraFlowForTextToImageTraining
from .util import convert_to_comfy_key
from .vae import DEFAULT_VAE_CONFIG as AURA_VAE_CONFIG

FLUX_VAE_SCALING_FACTOR = 0.3611
FLUX_VAE_SHIFT_FACTOR = 0.1159
AURA_VAE_SCALING_FACTOR = 0.13025


class AuraFlowForVAEEncoderMigrationConfig(AuraFlowConig):
    prior_preservation_loss: bool = True
    migration_loss: bool = True

    migration_freezing_threshold: Optional[float] = 1e-7

    flux_vae_repo_name: str = "black-forest-labs/FLUX.1-schnell"
    flux_vae_subfolder: str = "vae"
    vae_dtype: str = "bf16"

    patch_size: int = 2
    latent_channels: int = 16


def extend_init_x_linear(
    init_x_linear: Mapping[str, torch.Tensor], new_in_features: int
) -> dict[str, torch.Tensor]:
    """Zero-pad the projection's input columns: weight (out, old_in) ->
    (out, new_in) with zeros in the new columns; the bias unchanged."""
    weight = init_x_linear["weight"]
    out_dim, old_in = weight.shape
    new_weight = weight.new_zeros((out_dim, new_in_features))
    new_weight[:, :old_in] = weight
    return {**init_x_linear, "weight": new_weight}


def pad_patches(patches: torch.Tensor, new_dim: int) -> torch.Tensor:
    """Zero-pad the feature dim."""
    return F.pad(patches, (0, new_dim - patches.shape[-1]))


def _checkpoint_init_x_linear(path: str, device) -> dict[str, torch.Tensor]:
    """``init_x_linear``'s leaves of a single-file checkpoint (empty if the
    file has none); nothing else of the file is read."""
    from safetensors import safe_open

    from .util import convert_from_original_key

    with safe_open(path, framework="pt", device="cpu") as f:
        return {
            convert_from_original_key(k).split(".")[-1]: f.get_tensor(k).to(device)
            for k in f.keys() if "init_x_linear" in k
        }


class AuraFlowForVAEEncoderMigrationTraining(AuraFlowForTextToImageTraining):
    model_config: AuraFlowForVAEEncoderMigrationConfig
    model_config_class = AuraFlowForVAEEncoderMigrationConfig

    def setup_model(self) -> None:
        cfg = self.model_config
        self.patch_size = cfg.patch_size
        self.new_patch_dim = cfg.patch_size**2 * cfg.latent_channels
        inner_dim = cfg.denoiser.attention_head_dim * cfg.denoiser.num_attention_heads
        old_in = cfg.denoiser.patch_size**2 * cfg.denoiser.in_channels

        with torch.device("meta"):
            self.aura_vae = AutoencoderKL(AURA_VAE_CONFIG)
            self.flux_vae = AutoencoderKL(FLUX_VAE_CONFIG)
            init_x_linear = Linear(old_in, inner_dim)
            self.migration_scale = MigrationScaleFromZero(
                dim=self.new_patch_dim, freezing_threshold=cfg.migration_freezing_threshold
            )
        generator = torch.Generator(device=self.device).manual_seed(self.config.seed)
        for module in (self.aura_vae, self.flux_vae, init_x_linear, self.migration_scale):
            module.to_empty(device=self.device)
            init_parameters_(module, generator)
        leaves = dict(init_x_linear.state_dict())
        if os.path.exists(cfg.checkpoint_path):
            # only init_x_linear loads from the denoiser checkpoint
            leaves.update(_checkpoint_init_x_linear(cfg.checkpoint_path, self.device))
        leaves = extend_init_x_linear(leaves, self.new_patch_dim)
        with torch.device("meta"):
            extended = Linear(self.new_patch_dim, inner_dim)
        load_flat_params(extended, leaves, meta_device=self.device)
        self.params = nn.ModuleDict({
            "aura_vae": self.aura_vae,
            "flux_vae": self.flux_vae,
            "denoiser": nn.ModuleDict({"init_x_linear": extended}),
            "migration_scale": self.migration_scale,
        })
        self.params.eval()
        self.model = self  # this workload has no pipeline model

    # -- ModelForTraining surface ----------------------------------------------------

    def get_params(self) -> nn.ModuleDict:
        return self.params

    def trainable_filter(self, path: str) -> bool:
        return path.startswith("migration_scale.")

    def peft_extra_trainable_filter(self, path: str) -> bool:
        return path.startswith("migration_scale.")

    def after_setup_model(self) -> None:
        pass

    def sanity_check(self) -> None:
        img = torch.zeros((1, 64, 64, 3), dtype=torch.float32, device=self.device)
        with torch.no_grad():
            former = self.encode_aura_vae(img)
            latter = self.encode_flux_vae(img)
        if former.shape != latter.shape:
            raise RuntimeError(f"encoders disagree: {tuple(former.shape)} vs {tuple(latter.shape)}")

    def preprocess_batch(self, batch: dict) -> dict:
        pixels = np.asarray(batch["image"], np.float32)
        return {"pixel_values": torch.from_numpy(pixels).to(self.device)}

    # -- encode paths ------------------------------------------------------------------

    def encode_aura_vae(self, image: torch.Tensor) -> torch.Tensor:
        latent = self.aura_vae.encode(image).mode() * AURA_VAE_SCALING_FACTOR
        return pad_patches(patchify(latent, self.patch_size), self.new_patch_dim)

    def encode_flux_vae(self, image: torch.Tensor) -> torch.Tensor:
        latent = (self.flux_vae.encode(image).mode() - FLUX_VAE_SHIFT_FACTOR) * FLUX_VAE_SCALING_FACTOR
        return patchify(latent, self.patch_size)

    # -- loss ----------------------------------------------------------------------------

    def loss_fn(self, batch, generator=None):
        """``(loss, metrics)`` of one batch; no draw (the VAEs' modes)."""
        cfg = self.model_config
        image = batch["pixel_values"]
        with torch.no_grad():  # both VAEs are frozen
            former = self.encode_aura_vae(image)
            latter = self.encode_flux_vae(image)
            scaled_former = self.migration_scale.scale_negative(former)
        scale = self.migration_scale.inner_scale()
        mixed = scaled_former + self.migration_scale.scale_positive(latter)

        total = torch.zeros((), dtype=torch.float32, device=image.device)
        logs: dict = {"scale_mean": torch.mean(scale).detach()}
        if cfg.prior_preservation_loss:
            ppl = torch.mean(torch.square(former.float() - mixed.float()))
            logs["ppl_loss"] = ppl.detach()
            total = total + ppl
        if cfg.migration_loss:
            mig = torch.mean(torch.square(scale - 1.0))
            logs["migration_loss"] = mig.detach()
            total = total + mig
        return total, logs

    def eval_step(self, batch):
        raise NotImplementedError

    def preview_step(self, batch, preview_index):
        return []

    def get_state_dict_to_save(self):
        init_x_linear = self.params["denoiser"]["init_x_linear"]
        state_dict = {f"denoiser.init_x_linear.{k}": v for k, v in init_x_linear.state_dict().items()}
        state_dict["migration_scale.scale"] = self.migration_scale.scale
        if self._is_peft:
            state_dict.update(get_adapter_parameters(self.params))
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
