"""AuraFlow learned-PE -> RoPE migration training workload
(``vision_ft_tpu/models/auraflow/train_rope_migration.py`` counterpart).

The MMDiT carries both positional systems; one learnable scale s
(:class:`MigrationScaleFromZero`) blends frequencies of no rotation toward
RoPE while fading the learned positional encoding out:

    rope_freqs = base - s * (base - rope)      (base: cos 1, sin 0)
    patches   += (1 - s) * learned_pos_encoding

The losses: the flow-match velocity MSE, a pull of s toward 1, and an
optional prior-preservation MSE against the prediction with the adapters
and RoPE off. Draws come from one ``torch.Generator`` in a fixed order:
the VAE sample, the timesteps, the noise; :func:`loss_with_draws` takes
them explicitly.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Literal, Mapping, Optional

import torch

from ...modules.migration.scale import MigrationScaleFromZero
from ...modules.peft import get_adapter_parameters, while_peft_disabled
from ...modules.timestep.sampling import sigmoid_randn, uniform_rand
from .config import AuraFlowConig
from .denoiser import Denoiser
from .pipeline import AuraFlowModel
from .train_text_to_image import AuraFlowForTextToImageTraining, conditioning, velocity_loss
from .util import convert_to_comfy_key


class DenoiserForRoPEMigration(Denoiser):
    """The MMDiT with ``use_rope`` forced on, the learned positional
    encoding kept, and the migration scale between the two. ``use_rope``
    and ``migration`` are switches read at every forward."""

    def __init__(self, config) -> None:
        super().__init__(config.model_copy(update={"use_rope": True}))
        self.use_rope = True
        self.migration = True
        self.migration_scale = MigrationScaleFromZero(dim=1)

    def _position_encoding(self, patches, cond_len: int, height: int, width: int):
        if not self.use_rope:
            return patches + self.get_pos_encoding(height, width).to(patches.dtype), None
        rope_freqs = self._rope_freqs(cond_len, height, width, patches.device)
        if self.migration:
            base = torch.ones_like(rope_freqs)
            base[..., 1] = 0.0  # cos 1, sin 0: no rotation
            rope_freqs = base - self.migration_scale.scale_positive(base - rope_freqs)
            patches = patches + self.migration_scale.scale_negative(
                self.get_pos_encoding(height, width)
            ).to(patches.dtype)
        return patches, rope_freqs


class AuraFlowForRoPEMigration(AuraFlowModel):
    denoiser: DenoiserForRoPEMigration
    denoiser_class = DenoiserForRoPEMigration
    optional_denoiser_prefixes = ("migration_scale.",)

    @contextmanager
    def while_rope_disabled(self):
        tmp = self.denoiser.use_rope
        self.denoiser.use_rope = False
        try:
            yield
        finally:
            self.denoiser.use_rope = tmp

    @contextmanager
    def while_migration_disabled(self):
        tmp = self.denoiser.migration
        self.denoiser.migration = False
        try:
            yield
        finally:
            self.denoiser.migration = tmp


class AuraFlowForRoPEMigrationConfig(AuraFlowConig):
    noise_prediction_loss: bool = True
    migration_loss: bool = True
    prior_preservation_loss: bool = False

    migration_freezing_threshold: Optional[float] = 1e-7
    timestep_sampling: Literal["sigmoid", "uniform"] = "sigmoid"


def training_config(model: AuraFlowForRoPEMigration) -> AuraFlowForRoPEMigrationConfig:
    if isinstance(model.config, AuraFlowForRoPEMigrationConfig):
        return model.config
    return AuraFlowForRoPEMigrationConfig(**model.config.model_dump())


def _loss(model: AuraFlowForRoPEMigration, latents, hidden, timesteps, noise):
    config = training_config(model)
    loss, velocity_pred, noisy_latents = velocity_loss(model, latents, hidden, timesteps, noise)
    scale = model.denoiser.migration_scale.inner_scale()
    total = torch.zeros((), dtype=torch.float32, device=latents.device)
    logs: dict = {"rope_scale": torch.mean(scale).detach()}
    if config.noise_prediction_loss:
        logs["l2_loss"] = loss.detach()
        total = total + loss
    if config.migration_loss:
        mig = torch.mean(torch.square(scale - 1.0))
        logs["rope_migration_loss"] = mig.detach()
        total = total + mig
    if config.prior_preservation_loss:
        with torch.no_grad(), while_peft_disabled(), model.while_rope_disabled():
            preserved = model.denoiser(
                noisy_latents, hidden, timesteps.to(latents.device, latents.dtype)
            )
        ppl = torch.mean(torch.square(preserved.float() - velocity_pred.float()))
        logs["ppl_loss"] = ppl.detach()
        total = total + ppl
    return total, logs


def loss_with_draws(
    model: AuraFlowForRoPEMigration,
    batch: Mapping[str, torch.Tensor],
    vae_noise: torch.Tensor,
    timesteps: torch.Tensor,
    noise: torch.Tensor,
):
    """``(loss, metrics)`` for given draws: the VAE sample's noise (the
    moments' half shape), timesteps (B,) and fp32 noise of the latents'
    shape."""
    latents, hidden = conditioning(model, batch, vae_noise=vae_noise)
    return _loss(model, latents, hidden, timesteps, noise)


def loss_fn(model: AuraFlowForRoPEMigration, batch: Mapping[str, torch.Tensor],
            generator: torch.Generator):
    """``(loss, metrics)`` of one batch, every draw from ``generator``."""
    latents, hidden = conditioning(model, batch, generator=generator)
    if training_config(model).timestep_sampling == "sigmoid":
        timesteps = sigmoid_randn(generator, latents.shape)
    else:
        timesteps = uniform_rand(generator, latents.shape)
    noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
    return _loss(model, latents, hidden, timesteps, noise)


class AuraFlowForRoPEMigrationTraining(AuraFlowForTextToImageTraining):
    model: AuraFlowForRoPEMigration
    model_config: AuraFlowForRoPEMigrationConfig
    model_config_class = AuraFlowForRoPEMigrationConfig
    model_class = AuraFlowForRoPEMigration

    def setup_model(self) -> None:
        if not self.model_config.denoiser.use_rope:
            raise ValueError("This model is not for positional attention training")
        super().setup_model()
        scale = self.model.denoiser.migration_scale
        # the scale always starts at zero, a checkpoint's too
        scale.rezero()
        if self.model_config.migration_loss:
            scale.freezing_threshold = self.model_config.migration_freezing_threshold
        else:
            # migration off: the blend locked at full RoPE
            self.model.denoiser.migration = False
            scale.freezing_threshold = 2.0
            with torch.no_grad():
                scale.scale.fill_(1.0)

    def peft_extra_trainable_filter(self, path: str) -> bool:
        return self.model_config.migration_loss and path.startswith("denoiser.migration_scale.")

    def trainable_filter(self, path: str) -> bool:
        if path.startswith("denoiser.migration_scale."):
            return self.model_config.migration_loss
        return path.startswith("denoiser.")

    def loss_fn(self, batch, generator):
        return loss_fn(self.model, batch, generator)

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        state_dict["denoiser.migration_scale.scale"] = self.model.denoiser.migration_scale.scale
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
