"""Flux text encoder: CLIP-L's pooled output and T5-XXL's hidden states
(``vision_ft_tpu/models/flux/text_encoder.py`` counterpart).

CLIP-L's pooled embedding is the vector conditioning; T5's last hidden
state, multiplied by its attention mask (padded positions zeroed), is the
context. T5-XXL is classic T5: only the first layer owns the relative
position bias and every layer shares it (``per_layer_relative_bias=False``),
with the tanh GELU. Prompts split into positive and negative halves. The
pipeline ties T5's ``shared`` / ``encoder.embed_tokens`` pair and drops a
CLIP ``text_projection`` at load.

On the card CLIP-L's affine 768-wide LayerNorms take kernel A; its
77-key attention and T5's biased attention take the plain formula, as the
JAX dispatch has them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..text_encoders import CLIPTextModel
from ..text_encoders.clip import CLIPTextConfig
from ..text_encoders.umt5 import UMT5Config, UMT5EncoderModel
from ..utils import PooledTextEncodingOutput, PromptType, TextEncodingOutput

TEXT_ENCODER_CLIP_TENSOR_PREFIX = "text_encoders.clip_l.transformer."
TEXT_ENCODER_T5_TENSOR_PREFIX = "text_encoders.t5xxl.transformer."
DEFAULT_CLIP_MAX_TOKEN_LENGTH = 77
DEFAULT_T5_MAX_TOKEN_LENGTH = 512

# CLIP-L: the tower of SDXL's first text encoder
FLUX_CLIP_CONFIG = CLIPTextConfig()

# T5-XXL
FLUX_T5_CONFIG = UMT5Config(
    vocab_size=32128,
    d_model=4096,
    d_kv=64,
    d_ff=10240,
    num_layers=24,
    num_heads=64,
    dense_act_fn="gelu_new",
    per_layer_relative_bias=False,  # classic T5
)


class MultipleTextEncodingOutput(NamedTuple):
    clip: PooledTextEncodingOutput
    t5: TextEncodingOutput


class TextEncoder(nn.Module):
    """Keys ``clip.*`` (HF CLIP text model) and ``t5.*`` (T5 encoder)."""

    def __init__(self, clip_config=None, t5_config=None, clip_tokenizer=None,
                 t5_tokenizer=None):
        super().__init__()
        self.clip = CLIPTextModel(clip_config or FLUX_CLIP_CONFIG)
        self.t5 = UMT5EncoderModel(t5_config or FLUX_T5_CONFIG)
        self.clip_tokenizer = clip_tokenizer
        self.t5_tokenizer = t5_tokenizer

    # -- tensor cores -------------------------------------------------------------

    def encode_tokens_clip(self, input_ids: torch.Tensor) -> torch.Tensor:
        """CLIP's pooled output (B, 768)."""
        return self.clip(input_ids)[2]

    def encode_tokens_t5(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """T5's last hidden state with padded positions zeroed."""
        hidden = self.t5(input_ids, attention_mask)
        return hidden * attention_mask[..., None].to(hidden.dtype)

    # -- host prompt API ------------------------------------------------------------

    def normalize_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = True,
    ) -> tuple[list[str], list[str]]:
        _prompts = list(prompts) if isinstance(prompts, (list, tuple)) else [prompts]
        if not use_negative_prompts:
            _negatives = []
        elif negative_prompts is None:
            _negatives = [""] * len(_prompts)
        else:
            _negatives = (
                list(negative_prompts)
                if isinstance(negative_prompts, (list, tuple))
                else [negative_prompts]
            )
            if len(_negatives) == 1 and len(_prompts) > 1:
                _negatives = _negatives * len(_prompts)
        return _prompts, _negatives

    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = False,
        clip_max_token_length: int = DEFAULT_CLIP_MAX_TOKEN_LENGTH,
        t5_max_token_length: int = DEFAULT_T5_MAX_TOKEN_LENGTH,
    ) -> MultipleTextEncodingOutput:
        if self.clip_tokenizer is None or self.t5_tokenizer is None:
            raise RuntimeError("No tokenizers configured for TextEncoder")
        _prompts, _negatives = self.normalize_prompts(
            prompts, negative_prompts, use_negative_prompts
        )
        n_pos = len(_prompts)
        all_prompts = _prompts + _negatives
        device = self.t5.shared.weight.device

        clip_ids = np.asarray(
            self.clip_tokenizer(all_prompts, max_length=clip_max_token_length), np.int32
        )
        pooled = self.encode_tokens_clip(torch.from_numpy(clip_ids).long().to(device))

        t5_out = self.t5_tokenizer(
            all_prompts, max_length=t5_max_token_length, padding="max_length", truncation=True,
        )
        t5_ids = torch.from_numpy(np.asarray(t5_out["input_ids"], np.int32)).long().to(device)
        t5_mask = torch.from_numpy(np.asarray(t5_out["attention_mask"], np.int32)).to(device)
        hidden = self.encode_tokens_t5(t5_ids, t5_mask)
        mask_expanded = t5_mask[..., None].expand(hidden.shape)

        clip_out = PooledTextEncodingOutput(
            positive_embeddings=pooled[:n_pos],
            pooled_positive_embeddings=pooled[:n_pos],
            negative_embeddings=pooled[n_pos:],
            pooled_negative_embeddings=pooled[n_pos:],
        )
        t5_enc = TextEncodingOutput(
            positive_embeddings=hidden[:n_pos],
            positive_attention_mask=mask_expanded[:n_pos],
            negative_embeddings=hidden[n_pos:],
            negative_attention_mask=mask_expanded[n_pos:],
        )
        return MultipleTextEncodingOutput(clip=clip_out, t5=t5_enc)
