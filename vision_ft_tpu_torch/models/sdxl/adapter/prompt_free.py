"""SDXL Prompt-Free Generation (PFG) adapter (``vision_ft_tpu/models/sdxl/
adapter/prompt_free.py`` counterpart).

A frozen vision backbone and a trainable projector turn a reference image
into N pseudo context tokens, concatenated to the prompt embeddings along
the sequence axis: the positives get the tokens, the CFG negatives zeros.
The UNet is untouched; at ``max_token_length`` 225 the context holds
231 + 4 = 235 keys.

The image encoder is any callable from a normalized (B, 3, H, W) batch to
features (``models/auto.py`` ``AutoImageEncoder`` by default). The
projector is the module ``projector`` (``as_module()`` holds it beside the
three parts); it runs in fp32 in ``encode_reference_image`` (generate) and
in the model's dtype in the training loss. Adapter checkpoints hold it
under ``projector.``.

``preprocess_reference_image`` scales a PIL image's bytes to [0, 1] and
then normalizes with ``image_mean`` / ``image_std``. The JAX package
divides the [-1, 1] output of ``to_array`` by 255 again, which maps every
image to about -1 (see ROADMAP section 3).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ....dataset.transform import ColorChannelSwap, PaddedResize
from ....modules.adapter.prompt_free import PFGConfig, PFGManager
from ....nn import load_flat_params
from ....utils import safetensors as st
from ..config import SDXLConfig
from ..pipeline import SDXLModel


class SDXLModelWithPFGConfig(SDXLConfig):
    adapter: PFGConfig


def normalize_images(images, mean, std) -> np.ndarray:
    """PIL images -> (B, 3, H, W) fp32: bytes / 255, then (x - mean) / std."""
    arrays = [np.asarray(img.convert("RGB"), np.float32) / 255.0 for img in images]
    x = (np.stack(arrays) - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return x.transpose(0, 3, 1, 2).astype(np.float32)


def reference_from_dataset(images, mean, std) -> np.ndarray:
    """A dataset's NHWC reference batch in [-1, 1] -> the encoder's
    normalized NCHW batch."""
    x = (np.asarray(images, np.float32) + 1.0) / 2.0
    x = (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
    return x.transpose(0, 3, 1, 2).astype(np.float32)


def run_in_fp32(module: nn.Module, *args) -> torch.Tensor:
    """``module(*args)`` on fp32 copies of its parameters (differentiable
    back to them) and fp32 inputs."""
    params = {k: v.float() for k, v in module.named_parameters()}
    return torch.func.functional_call(module, params, tuple(a.float() for a in args))


def materialize_(module: nn.Module, dtype: torch.dtype, device) -> None:
    """``module`` in ``dtype`` on ``device``, emptied there if it is
    still on the meta device."""
    module.to(dtype=dtype)
    if any(t.is_meta for t in module.parameters()):
        module.to_empty(device=device)
    else:
        module.to(device)


class SDXLModelWithPFG(SDXLModel):
    """SDXL + an image encoder + the PFG projector."""

    config: SDXLModelWithPFGConfig

    def __init__(self, config: SDXLModelWithPFGConfig, tokenizer=None,
                 image_encoder: Optional[Callable] = None, **kwargs):
        super().__init__(config, tokenizer=tokenizer, **kwargs)
        self.manager = PFGManager(adapter_config=config.adapter)
        with torch.device("meta"):
            self.projector = self.manager.get_projector(out_features=config.denoiser.context_dim)
        self.vision_encoder = image_encoder
        acfg = config.adapter
        self._resize = PaddedResize(acfg.image_size, fill=acfg.background_color)
        self._swap = ColorChannelSwap(
            swap=(2, 1, 0) if acfg.color_channel == "bgr" else (0, 1, 2),
            skip=acfg.color_channel == "rgb",
        )

    def _default_image_encoder(self):
        from ...auto import AutoImageEncoder, TimmModelConfig

        return AutoImageEncoder(TimmModelConfig(**self.config.adapter.image_encoder),
                                device=self.device)

    def as_module(self) -> nn.ModuleDict:
        return nn.ModuleDict({**self._parts(), "projector": self.projector})

    # -- parameters ----------------------------------------------------------------

    def init_params(self, generator, dtype=None, device=None) -> None:
        super().init_params(generator, dtype, device)
        self.init_adapter_params(generator)

    def init_adapter_params(self, generator: torch.Generator) -> None:
        materialize_(self.projector, self.dtype, self.device)
        self.projector.init_weights(generator)

    def load_state_dict(self, flat, device=None) -> None:
        """The base model's flat state dict, with or without ``projector.*``;
        an absent projector is drawn from a generator seeded 0."""
        flat = dict(flat)
        projector = {k[len("projector."):]: flat.pop(k) for k in list(flat)
                     if k.startswith("projector.")}
        super().load_state_dict(flat, device)
        self._load_projector(projector)

    def _load_projector(self, projector: dict) -> None:
        if projector:
            materialize_(self.projector, self.dtype, self.device)
            load_flat_params(self.projector, projector)
        else:
            self.init_adapter_params(torch.Generator(device=self.device).manual_seed(0))

    def _from_checkpoint(self, device=None) -> None:
        super()._from_checkpoint(device)
        projector = {}
        if path := self.config.adapter.checkpoint_weight:
            projector = {k[len("projector."):]: v
                         for k, v in st.load_file(path, dtype=self.dtype).items()
                         if k.startswith("projector.")}
        self._load_projector(projector)

    def adapter_state_dict(self) -> dict[str, torch.Tensor]:
        return {f"projector.{k}": v for k, v in self.projector.state_dict().items()}

    # -- reference image -------------------------------------------------------------

    def preprocess_reference_image(self, reference_image) -> np.ndarray:
        """PIL image(s) -> normalized (B, 3, H, W) fp32: padded to the
        square ``image_size``, channels swapped for "bgr", bytes / 255,
        then ``image_mean`` / ``image_std``. An array passes through."""
        if isinstance(reference_image, Image.Image):
            reference_image = [reference_image]
        if isinstance(reference_image, (list, tuple)):
            acfg = self.config.adapter
            images = [Image.fromarray(self._swap(np.asarray(self._resize(img).convert("RGB"))))
                      for img in reference_image]
            return normalize_images(images, acfg.image_mean, acfg.image_std)
        return np.asarray(reference_image, np.float32)

    def encode_image_features(self, pixel_values) -> torch.Tensor:
        """The frozen encoder's features of a normalized NCHW batch, fp32
        on the model's device."""
        if self.vision_encoder is None:
            self.vision_encoder = self._default_image_encoder()
        return torch.as_tensor(self.vision_encoder(pixel_values)).to(self.device).float()

    def encode_reference_image(self, pixel_values) -> torch.Tensor:
        """The image tokens (B, N, context_dim), the projector in fp32."""
        return run_in_fp32(self.projector, self.encode_image_features(pixel_values))

    # -- generate ----------------------------------------------------------------------

    @torch.inference_mode()
    def generate(
        self,
        prompt,
        negative_prompt=None,
        reference_image=None,
        width: int = 768,
        height: int = 768,
        original_size=None,
        target_size=None,
        crop_coords_top_left=(0, 0),
        num_inference_steps: int = 20,
        cfg_scale: float = 3.5,
        max_token_length: int = 75,
        seed: Optional[int] = None,
    ) -> list[Image.Image]:
        do_cfg = cfg_scale > 1.0
        timesteps = self.scheduler.get_timesteps(num_inference_steps)
        sigmas = self.scheduler.get_sigmas(timesteps)
        batch_size = len(prompt) if isinstance(prompt, (list, tuple)) else 1
        original_size = original_size or (height, width)
        target_size = target_size or (height, width)

        encoder_output = self.text_encoder.encode_prompts(
            prompt, negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length,
        )
        embeddings, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        if reference_image is not None:
            image_tokens = self.encode_reference_image(
                self.preprocess_reference_image(reference_image)
            )
            image_tokens = image_tokens.repeat(batch_size, 1, 1)
            if do_cfg:
                # zeros for the negatives, after the positives
                image_tokens = torch.cat([image_tokens, torch.zeros_like(image_tokens)])
            embeddings = torch.cat([embeddings, image_tokens.to(embeddings.dtype)], dim=1)
        return self._generate_core(
            embeddings, pooled, batch_size, height, width, original_size, target_size,
            crop_coords_top_left, timesteps, sigmas, cfg_scale, 0.0, do_cfg, seed,
        )
