"""Shared model output types (``vision_ft_tpu/models/utils.py`` counterpart)."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Union

import torch

PromptType = Union[str, Sequence[str]]


class TextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    positive_attention_mask: torch.Tensor
    negative_embeddings: torch.Tensor
    negative_attention_mask: torch.Tensor


class PooledTextEncodingOutput(NamedTuple):
    positive_embeddings: torch.Tensor
    pooled_positive_embeddings: torch.Tensor
    negative_embeddings: torch.Tensor
    pooled_negative_embeddings: torch.Tensor
