"""SDXL style tokenizer adapter (``vision_ft_tpu/models/sdxl/adapter/
style_tokenizer.py`` counterpart).

A ``<|style|>`` special token is added to the CLIP tokenizer. A prompt
writes it once, and it is expanded to ``num_style_tokens`` copies; at
encode time a frozen vision backbone and two trainable projectors (one a
tower) make that many embeddings an image, scattered into each text
tower's input embedding at the style-token positions
(``CLIPTextModel.forward(style_embeddings=...)``). The CFG negatives get
zero style vectors, after the positives' in the scatter's row-major order.

``setup_style_token`` grows both token-embedding matrices to
``len(tokenizer)`` rows with the mean row (a placeholder: the scatter
replaces it wherever the token appears). The towers' ``vocab_size`` and
so their eos id (``vocab_size - 1``, where the pooled output is read)
stay as they were.

Adapter checkpoints hold the projectors under ``projector_1.`` /
``projector_2.``. The projectors run in fp32 in ``generate()`` and in the
training loss, as in the JAX package. The reference image is normalized
from its bytes, as in ``adapter/prompt_free.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from PIL import Image
from torch import nn

from ....dataset.transform import PaddedResize
from ....modules.adapter.style_tokenizer import StyleTokenizerConfig, StyleTokenizerManager
from ....modules.long_prompt import tokenize_long_prompt
from ....nn import load_flat_params
from ....utils import safetensors as st
from ...utils import PooledTextEncodingOutput, TextEncodingOutput
from ..config import SDXLConfig
from ..pipeline import SDXLModel
from ..text_encoder import (
    CHUNK_LENGTH,
    MultipleTextEncodingOutput,
    TextEncoder,
    _merge_chunks,
    _merge_mask_chunks,
)
from .prompt_free import SDXLModelWithPFG, materialize_, normalize_images, run_in_fp32

_PROJECTORS = ("projector_1", "projector_2")


class SDXLModelWithStyleTokenizerConfig(SDXLConfig):
    adapter: StyleTokenizerConfig


class ReferenceEncodeOutput(NamedTuple):
    style_tokens_1: torch.Tensor
    style_tokens_2: torch.Tensor


class TextEncoderWithStyle(TextEncoder):
    """Both CLIP towers with the style scatter; one shared tokenizer, so
    one style token id for both."""

    style_token: str = "<|style|>"
    num_style_tokens: int = 4
    style_token_id: Optional[int] = None

    def append_style_token_id(self, style_token: str = "<|style|>",
                              num_style_tokens: int = 4) -> None:
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured")
        self.style_token = style_token
        self.num_style_tokens = num_style_tokens
        self.tokenizer.add_tokens(style_token, special_tokens=True)
        self.style_token_id = self.tokenizer.convert_tokens_to_ids(style_token)

    def preprocess_style_token(self, prompts):
        expand = lambda p: p.replace(self.style_token, self.style_token * self.num_style_tokens)
        if isinstance(prompts, str):
            return expand(prompts)
        if isinstance(prompts, (list, tuple)):
            return [expand(p) for p in prompts]
        return prompts

    def encode_tokens_with_style(
        self,
        input_ids: torch.Tensor,
        batch: int,
        style_embeddings_1: Optional[torch.Tensor] = None,
        style_embeddings_2: Optional[torch.Tensor] = None,
    ):
        """Chunked ids (batch*num_chunks, 77) and each tower's style
        vectors -> (emb1, emb2, pooled2), chunk-merged as ``encode_tokens``."""
        _, penult_1, _ = self.text_encoder_1(
            input_ids, style_embeddings=style_embeddings_1, style_token_id=self.style_token_id
        )
        _, penult_2, text_embeds = self.text_encoder_2(
            input_ids, style_embeddings=style_embeddings_2, style_token_id=self.style_token_id
        )
        emb1 = _merge_chunks(penult_1, batch)
        emb2 = _merge_chunks(penult_2, batch)
        pooled = text_embeds.reshape(batch, -1, text_embeds.shape[-1])[:, 0]
        return emb1, emb2, pooled

    def encode_prompts(
        self,
        prompts,
        style_tokens_1: Optional[torch.Tensor] = None,
        style_tokens_2: Optional[torch.Tensor] = None,
        negative_prompts=None,
        negative_style_tokens_1: Optional[torch.Tensor] = None,
        negative_style_tokens_2: Optional[torch.Tensor] = None,
        use_negative_prompts: bool = False,
        max_token_length: int = CHUNK_LENGTH,
    ) -> MultipleTextEncodingOutput:
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured")
        _prompts, _negatives = self.normalize_prompts(
            self.preprocess_style_token(prompts),
            self.preprocess_style_token(negative_prompts) if negative_prompts is not None else None,
            use_negative_prompts,
        )
        num_positive = len(_prompts)
        all_prompts = _prompts + _negatives
        batch = len(all_prompts)
        ids, mask = tokenize_long_prompt(
            self.tokenizer, all_prompts, max_length=max_token_length, chunk_length=CHUNK_LENGTH
        )
        device = next(self.parameters()).device
        ids = torch.from_numpy(ids).long().to(device)

        def cat_styles(pos, neg):
            if pos is None:
                return None
            neg = torch.zeros_like(pos) if neg is None else neg
            return torch.cat([pos, neg]) if use_negative_prompts else pos

        emb1, emb2, pooled = self.encode_tokens_with_style(
            ids, batch,
            style_embeddings_1=cat_styles(style_tokens_1, negative_style_tokens_1),
            style_embeddings_2=cat_styles(style_tokens_2, negative_style_tokens_2),
        )
        merged_mask = _merge_mask_chunks(torch.from_numpy(mask).to(device), batch)
        out1 = TextEncodingOutput(
            positive_embeddings=emb1[:num_positive],
            positive_attention_mask=merged_mask[:num_positive],
            negative_embeddings=emb1[num_positive:],
            negative_attention_mask=merged_mask[num_positive:],
        )
        out2 = PooledTextEncodingOutput(
            positive_embeddings=emb2[:num_positive],
            pooled_positive_embeddings=pooled[:num_positive],
            negative_embeddings=emb2[num_positive:],
            pooled_negative_embeddings=pooled[num_positive:],
        )
        return MultipleTextEncodingOutput(out1, out2)


class SDXLModelWithStyleTokenizer(SDXLModel):
    """SDXL + an image encoder + a style projector for each CLIP tower."""

    config: SDXLModelWithStyleTokenizerConfig
    text_encoder_class = TextEncoderWithStyle

    def __init__(self, config: SDXLModelWithStyleTokenizerConfig, tokenizer=None,
                 image_encoder: Optional[Callable] = None, **kwargs):
        super().__init__(config, tokenizer=tokenizer, **kwargs)
        self.manager = StyleTokenizerManager(adapter_config=config.adapter)
        with torch.device("meta"):
            self.projector_1 = self.manager.get_projector(
                out_features=self.text_encoder.text_encoder_1.config.hidden_size
            )
            self.projector_2 = self.manager.get_projector(
                out_features=self.text_encoder.text_encoder_2.config.hidden_size
            )
        self.vision_encoder = image_encoder
        self._resize = PaddedResize(config.adapter.image_size, fill=config.adapter.background_color)

    _default_image_encoder = SDXLModelWithPFG._default_image_encoder

    def as_module(self) -> nn.ModuleDict:
        return nn.ModuleDict({**self._parts(), "projector_1": self.projector_1,
                              "projector_2": self.projector_2})

    # -- the style token ---------------------------------------------------------------

    @torch.no_grad()
    def setup_style_token(self) -> None:
        """Register the token and grow both token-embedding matrices to
        ``len(tokenizer)`` rows, the new rows the mean row."""
        self.text_encoder.append_style_token_id(
            style_token=self.config.adapter.style_token,
            num_style_tokens=self.config.adapter.num_style_tokens,
        )
        new_size = len(self.text_encoder.tokenizer)
        for tower in (self.text_encoder.text_encoder_1, self.text_encoder.text_encoder_2):
            embedding = tower.text_model["embeddings"]["token_embedding"]
            w = embedding.weight
            if w.shape[0] < new_size:
                mean_row = w.float().mean(dim=0, keepdim=True)
                pad = mean_row.expand(new_size - w.shape[0], -1).to(w.dtype)
                embedding.weight = nn.Parameter(torch.cat([w, pad]), requires_grad=w.requires_grad)
                embedding.num_embeddings = new_size

    # -- parameters / checkpoints -------------------------------------------------------

    def _projectors(self) -> dict[str, nn.Module]:
        return {name: getattr(self, name) for name in _PROJECTORS}

    def init_params(self, generator, dtype=None, device=None) -> None:
        super().init_params(generator, dtype, device)
        self.init_adapter_params(generator)
        self.setup_style_token()

    def init_adapter_params(self, generator: torch.Generator) -> None:
        for projector in self._projectors().values():
            materialize_(projector, self.dtype, self.device)
            projector.init_weights(generator)

    def _load_projectors(self, flat: dict) -> None:
        if not any(k.startswith(_PROJECTORS) for k in flat):
            self.init_adapter_params(torch.Generator(device=self.device).manual_seed(0))
            return
        for name, projector in self._projectors().items():
            materialize_(projector, self.dtype, self.device)
            load_flat_params(projector, {k[len(name) + 1:]: v for k, v in flat.items()
                                         if k.startswith(name + ".")})

    def load_state_dict(self, flat, device=None) -> None:
        """The base model's flat state dict (token embeddings at the
        towers' ``vocab_size`` rows), with or without ``projector_1.*`` /
        ``projector_2.*``; then the style token is set up. Absent
        projectors are drawn from a generator seeded 0."""
        flat = dict(flat)
        projectors = {k: flat.pop(k) for k in list(flat) if k.startswith(_PROJECTORS)}
        super().load_state_dict(flat, device)
        self.setup_style_token()
        self._load_projectors(projectors)

    def _from_checkpoint(self, device=None) -> None:
        super()._from_checkpoint(device)
        self.setup_style_token()
        flat = {}
        if path := self.config.adapter.checkpoint_weight:
            flat = st.load_file(path, dtype=self.dtype)
        self._load_projectors(flat)

    def adapter_state_dict(self) -> dict[str, torch.Tensor]:
        return {f"{name}.{k}": v for name, projector in self._projectors().items()
                for k, v in projector.state_dict().items()}

    # -- reference image ------------------------------------------------------------------

    def preprocess_reference_image(self, reference_image) -> np.ndarray:
        if isinstance(reference_image, Image.Image):
            reference_image = [reference_image]
        if isinstance(reference_image, (list, tuple)):
            acfg = self.config.adapter
            return normalize_images([self._resize(img) for img in reference_image],
                                    acfg.image_mean, acfg.image_std)
        return np.asarray(reference_image, np.float32)

    encode_image_features = SDXLModelWithPFG.encode_image_features

    def project_style_tokens(self, features: torch.Tensor) -> ReferenceEncodeOutput:
        """Both projectors in fp32 (differentiable to their parameters)."""
        return ReferenceEncodeOutput(run_in_fp32(self.projector_1, features),
                                     run_in_fp32(self.projector_2, features))

    def encode_reference_image(self, pixel_values) -> ReferenceEncodeOutput:
        return self.project_style_tokens(self.encode_image_features(pixel_values))

    # -- generate -----------------------------------------------------------------------------

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

        tokens_1 = tokens_2 = None
        if reference_image is not None:
            tokens_1, tokens_2 = self.encode_reference_image(
                self.preprocess_reference_image(reference_image)
            )
        encoder_output = self.text_encoder.encode_prompts(
            prompt, style_tokens_1=tokens_1, style_tokens_2=tokens_2,
            negative_prompts=negative_prompt, use_negative_prompts=do_cfg,
            max_token_length=max_token_length,
        )
        embeddings, pooled = self.prepare_encoder_hidden_states(encoder_output, do_cfg)
        return self._generate_core(
            embeddings, pooled, batch_size, height, width, original_size, target_size,
            crop_coords_top_left, timesteps, sigmas, cfg_scale, 0.0, do_cfg, seed,
        )
