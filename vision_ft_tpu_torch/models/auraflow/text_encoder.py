"""AuraFlow text encoder: UMT5 (Pile-T5-XL) and the prompt API
(``vision_ft_tpu/models/auraflow/text_encoder.py`` counterpart).

The last hidden state is multiplied by the attention mask (padded positions
zeroed), split into positive and negative halves, at most 256 tokens. The
UMT5 model sits under ``model.``, so the keys are
``text_encoder.model.*`` under the pipeline (the original checkpoint's
``text_encoders.pile_t5xl.transformer.*``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..text_encoders.umt5 import AURAFLOW_UMT5_CONFIG, UMT5Config, UMT5EncoderModel
from ..utils import PromptType, TextEncodingOutput

DEFAULT_MAX_TOKEN_LENGTH = 256
TEXT_ENCODER_TENSOR_PREFIX = "text_encoders.pile_t5xl.transformer."


class TextEncoder(nn.Module):
    def __init__(self, config: Optional[UMT5Config] = None, tokenizer=None):
        super().__init__()
        self.model = UMT5EncoderModel(config or AURAFLOW_UMT5_CONFIG)
        self.tokenizer = tokenizer

    def encode_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor):
        """(hidden states with padded positions zeroed, attention_mask)."""
        hidden = self.model(input_ids, attention_mask)
        return hidden * attention_mask[..., None].to(hidden.dtype), attention_mask

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

    def tokenize(self, prompts: list[str], max_token_length: int):
        """The tokenizer must return ``input_ids`` and ``attention_mask``
        (a Hugging Face tokenizer's call)."""
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured for TextEncoder")
        out = self.tokenizer(
            prompts, max_length=max_token_length, padding="max_length", truncation=True
        )
        return (
            np.asarray(out["input_ids"], np.int32),
            np.asarray(out["attention_mask"], np.int32),
        )

    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = False,
        max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH,
    ) -> TextEncodingOutput:
        _prompts, _negatives = self.normalize_prompts(
            prompts, negative_prompts, use_negative_prompts
        )
        n_pos = len(_prompts)
        ids, mask = self.tokenize(_prompts + _negatives, max_token_length)
        device = self.model.shared.weight.device
        hidden, attn = self.encode_tokens(
            torch.from_numpy(ids).long().to(device), torch.from_numpy(mask).to(device)
        )
        mask_expanded = attn[..., None].expand(hidden.shape)
        return TextEncodingOutput(
            positive_embeddings=hidden[:n_pos],
            positive_attention_mask=mask_expanded[:n_pos],
            negative_embeddings=hidden[n_pos:],
            negative_attention_mask=mask_expanded[n_pos:],
        )
