"""AuraFlow shortcut-model training workload (``vision_ft_tpu/models/
auraflow/train_shortcut.py`` counterpart).

Each sample is either a flow-matching sample (t from the grid 1/max ..
max/max, duration 1/max) or a self-consistency sample (a power-of-two
duration; the target is the mean of two half-duration predictions of the
current model, times ``shortcut_cfg_scale``), by a Bernoulli draw at
``flow_matching_ratio``. As in the JAX package, both target kinds are made
for the whole batch (fixed shapes, two extra forwards without gradients)
and blended per sample, so the two packages compute the same thing. The
shortcut embedder is zero-initialized, so the base model's flow is
untouched at step 0, and it stays fully trainable under LoRA.

Draws come from one ``torch.Generator`` in a fixed order: the VAE sample,
the Bernoulli uniforms, the flow-matching steps, the flow-matching noise,
the shortcut durations (exponents, then departures), the shortcut noise;
:func:`loss_with_draws` takes them explicitly (:class:`ShortcutDraws`).
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
from PIL import Image

from ...modules.loss.flow_match import get_flow_match_target_velocity, prepare_noised_latents
from ...modules.loss.shortcut import (
    ShortcutDuration,
    get_shortcut_target_velocity,
    prepare_random_shortcut_durations,
    prepare_self_consistency_targets,
)
from ...modules.peft import get_adapter_parameters
from .config import AuraFlowConig
from .denoiser import Denoiser
from .pipeline import AuraFlowModel
from .text_encoder import DEFAULT_MAX_TOKEN_LENGTH
from .train_text_to_image import AuraFlowForTextToImageTraining, conditioning
from .util import convert_to_comfy_key


class DenoiserForShortcut(Denoiser):
    """The MMDiT with ``use_shortcut`` forced on, so that the shortcut
    embedder exists."""

    def __init__(self, config) -> None:
        super().__init__(config.model_copy(update={"use_shortcut": True}))

    @torch.no_grad()
    def reset_shortcut_params(self) -> None:
        """Both MLP layers of the shortcut embedder to zero."""
        for layer in self.shortcut_embedder.mlp.values():
            layer.weight.zero_()
            layer.bias.zero_()


class AuraFlowForShortcut(AuraFlowModel):
    denoiser_class = DenoiserForShortcut
    optional_denoiser_prefixes = ("shortcut_embedder.",)

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
    ) -> list[Image.Image]:
        """Euler steps of 1 / ``num_inference_steps`` from t = 1, each with
        that shortcut duration. As in the port's ``AuraFlowModel``, the
        guidance and the update run in fp32 and the latents stay in the
        model's dtype."""
        del do_offloading  # accepted and ignored, as in the JAX package
        do_cfg = cfg_scale > 1.0
        timesteps = np.arange(1000, 0, -1000 / num_inference_steps)
        delta = 1.0 / num_inference_steps
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg, max_token_length=max_token_length,
        )
        embeddings = torch.cat(
            [encoder_output.positive_embeddings, encoder_output.negative_embeddings]
        ).to(self.dtype)
        latents = self.prepare_latents(batch_size, height, width, seed=seed)
        for t in timesteps:
            model_input = torch.cat([latents, latents]) if do_cfg else latents
            b = model_input.shape[0]
            velocity = self.denoiser(
                model_input, embeddings,
                torch.full((b,), float(np.float32(t / 1000.0)), device=latents.device).to(self.dtype),
                shortcut_duration=torch.full((b,), delta, device=latents.device).to(self.dtype),
            )
            if do_cfg:
                positive, negative = velocity.chunk(2)
                velocity = negative.float() + float(np.float32(cfg_scale)) * (positive - negative).float()
            latents = (latents.float() - velocity.float() * delta).to(latents.dtype)
        return self.decode_image(latents)


class AuraFlowForShortcutConfig(AuraFlowConig):
    flow_matching_ratio: float = 0.75
    shortcut_min_steps: int = 1
    shortcut_max_steps: int = 128
    shortcut_cfg_scale: float = 5.0

    timestep_sampling_type: str = "sigmoid"


class ShortcutDraws(NamedTuple):
    """The draws of one shortcut loss after the VAE sample's: uniforms (B,)
    for the Bernoulli mask, the flow-matching steps (B,) in [1, max], fp32
    noise of the latents' shape for each group, the durations."""

    flow_uniform: torch.Tensor
    flow_steps: torch.Tensor
    flow_noise: torch.Tensor
    durations: ShortcutDuration
    shortcut_noise: torch.Tensor


def draw(config: AuraFlowForShortcutConfig, generator: torch.Generator,
         latents_shape) -> ShortcutDraws:
    """The draws after the VAE sample's from ``generator``, in the order
    the module docstring gives."""
    device, b = generator.device, latents_shape[0]

    def randn(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)

    flow_uniform = torch.rand((b,), generator=generator, device=device)
    flow_steps = torch.randint(1, config.shortcut_max_steps + 1, (b,), generator=generator,
                               device=device)
    flow_noise = randn(latents_shape)
    durations = prepare_random_shortcut_durations(
        generator, b, min_pow=int(math.log2(config.shortcut_min_steps)),
        max_pow=int(math.log2(config.shortcut_max_steps)),
    )
    return ShortcutDraws(flow_uniform, flow_steps, flow_noise, durations, randn(latents_shape))


def _loss(model: AuraFlowForShortcut, config: AuraFlowForShortcutConfig, latents, hidden,
          d: ShortcutDraws):
    dtype, device = model.dtype, latents.device
    flow_mask = d.flow_uniform.to(device) <= config.flow_matching_ratio
    max_steps = config.shortcut_max_steps
    t_fm = d.flow_steps.to(device).float() / max_steps
    d_fm = torch.full_like(t_fm, 1.0 / max_steps)
    noisy_fm, noise_fm = prepare_noised_latents(None, latents, t_fm, noise=d.flow_noise)
    target_fm = get_flow_match_target_velocity(latents, noise_fm)

    departure = d.durations.departure_timesteps.to(device)
    duration = d.durations.shortcut_duration.to(device)
    noisy_sc, _ = prepare_noised_latents(None, latents, departure, noise=d.shortcut_noise)

    def denoise(lat, t, dur):
        return model.denoiser(lat.to(dtype), hidden, t.to(dtype), shortcut_duration=dur.to(dtype))

    first, second = prepare_self_consistency_targets(
        denoise, noisy_sc, departure, duration, cfg_scale=config.shortcut_cfg_scale
    )
    target_sc = get_shortcut_target_velocity(first, second)

    m1 = flow_mask[:, None, None, None]
    noisy = torch.where(m1, noisy_fm, noisy_sc)
    t = torch.where(flow_mask, t_fm, departure)
    dur = torch.where(flow_mask, d_fm, duration)
    target = torch.where(m1, target_fm, target_sc).detach()

    prediction = denoise(noisy, t, dur)
    per_sample = torch.mean(torch.square(prediction.float() - target.float()), dim=(1, 2, 3))
    loss = torch.mean(per_sample)
    mask = flow_mask.float()
    logs = {
        "flow_match": (torch.sum(per_sample * mask) / torch.clamp(mask.sum(), min=1)).detach(),
        "shortcut": (torch.sum(per_sample * (1 - mask)) / torch.clamp((1 - mask).sum(), min=1)).detach(),
        "flow_match_fraction": mask.mean(),
    }
    return loss, logs


def training_config(model: AuraFlowForShortcut) -> AuraFlowForShortcutConfig:
    if isinstance(model.config, AuraFlowForShortcutConfig):
        return model.config
    return AuraFlowForShortcutConfig(**model.config.model_dump())


def loss_with_draws(model: AuraFlowForShortcut, batch: Mapping[str, torch.Tensor],
                    vae_noise: torch.Tensor, draws: ShortcutDraws):
    """``(loss, metrics)`` of one batch for given draws: the VAE sample's
    noise (the moments' half shape) and the rest."""
    latents, hidden = conditioning(model, batch, vae_noise=vae_noise)
    return _loss(model, training_config(model), latents, hidden, draws)


def loss_fn(model: AuraFlowForShortcut, batch: Mapping[str, torch.Tensor],
            generator: torch.Generator):
    """``(loss, metrics)`` of one batch, every draw from ``generator``."""
    config = training_config(model)
    latents, hidden = conditioning(model, batch, generator=generator)
    return _loss(model, config, latents, hidden, draw(config, generator, latents.shape))


class AuraFlowForShortcutTraining(AuraFlowForTextToImageTraining):
    model: AuraFlowForShortcut
    model_config: AuraFlowForShortcutConfig
    model_config_class = AuraFlowForShortcutConfig
    model_class = AuraFlowForShortcut

    def setup_model(self) -> None:
        super().setup_model()
        # a base checkpoint carries no shortcut embedder: it starts at zero
        self.model.denoiser.reset_shortcut_params()

    def peft_extra_trainable_filter(self, path: str) -> bool:
        return path.startswith("denoiser.shortcut_embedder.")

    def sanity_check(self) -> None:
        latent, prompt, t = self._sanity_inputs()
        with torch.no_grad():
            out = self.model.denoiser(latent, prompt, t, shortcut_duration=t)
            emb = self.model.denoiser.shortcut_embedder(t)
        if out.shape != latent.shape:
            raise RuntimeError(f"denoiser gave {tuple(out.shape)} for {tuple(latent.shape)}")
        # the zero-initialized embedder is a no-op before training
        if float(emb.abs().max()) != 0.0:
            raise RuntimeError("the shortcut embedder is not zero at step 0")

    def loss_fn(self, batch, generator):
        return loss_fn(self.model, batch, generator)

    def get_state_dict_to_save(self):
        if not self._is_peft:
            return self.model.state_dict()
        state_dict = get_adapter_parameters(self.get_params())
        for k, v in self.model.denoiser.shortcut_embedder.state_dict().items():
            state_dict[f"denoiser.shortcut_embedder.{k}"] = v
        return {convert_to_comfy_key(k): v for k, v in state_dict.items()}
