"""Lumina2 text encoder: Gemma-2-2B penultimate hidden states
(``vision_ft_tpu/models/lumina2/text_encoder.py`` counterpart).

Prompts are padded to ``max_token_length`` (the extra positions are masked;
the NextDiT's holey layout handles them exactly). Parameter keys:
``model.*``, under the pipeline's ``text_encoder.`` prefix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..text_encoders.gemma2 import LUMINA2_GEMMA2_CONFIG, Gemma2Config, Gemma2Model
from ..utils import PromptType, TextEncodingOutput

DEFAULT_MAX_TOKEN_LENGTH = 256
TEXT_ENCODER_TENSOR_PREFIX = "text_encoders.gemma2_2b.transformer."


class TextEncoder(nn.Module):
    def __init__(self, config: Optional[Gemma2Config] = None, tokenizer=None):
        super().__init__()
        self.model = Gemma2Model(config or LUMINA2_GEMMA2_CONFIG)
        self.tokenizer = tokenizer

    def encode_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Penultimate hidden states (B, S, hidden)."""
        _, penultimate = self.model(input_ids, attention_mask)
        return penultimate

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
        device = self.model.embed_tokens.weight.device
        mask = torch.from_numpy(mask).to(device)
        hidden = self.encode_tokens(torch.from_numpy(ids).long().to(device), mask)
        return TextEncodingOutput(
            positive_embeddings=hidden[:n_pos],
            positive_attention_mask=mask[:n_pos],
            negative_embeddings=hidden[n_pos:],
            negative_attention_mask=mask[n_pos:],
        )
