"""CogView4 text encoder: GLM-4's penultimate hidden state and the prompt
API (``vision_ft_tpu/models/cogview4/text_encoder.py`` counterpart).

Prompts are padded to the longest in the call, then left-padded with the
tokenizer's ``pad_token_id`` (0 without one) to a multiple of 16. The
attention inside runs unmasked and the returned masks are all ones, as in
the JAX package. The GLM model sits under ``model.``, so the keys are
``text_encoder.model.*`` under the pipeline (the single file's
``text_encoder.*``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..text_encoders.glm import COGVIEW4_GLM_CONFIG, GlmConfig, GlmModel
from ..utils import PromptType, TextEncodingOutput

DEFAULT_MAX_TOKEN_LENGTH = 1024
TEXT_ENCODER_TENSOR_PREFIX = "text_encoder."


def pad_token_ids(tokenizer, prompts: list[str], max_token_length: int) -> np.ndarray:
    """(N, L) int32 ids: "longest" padding, then left padding to a multiple
    of 16. Rows a tokenizer leaves unequal (one that does not pad to the
    longest itself) are padded to the longest first, on the tokenizer's
    ``padding_side`` ("right", Hugging Face's default, where it names
    none). Which side GLM-4's own tokenizer pads on is not verified here:
    its files are not at hand, and with the unmasked DiT the side changes
    the embedding of the shorter prompt."""
    out = tokenizer(prompts, max_length=max_token_length, padding="longest", truncation=True)
    rows = [list(row) for row in out["input_ids"]]
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    left = getattr(tokenizer, "padding_side", "right") == "left"
    longest = max(len(row) for row in rows)
    pads = [[pad_id] * (longest - len(row)) for row in rows]
    ids = np.asarray([pad + row if left else row + pad for pad, row in zip(pads, rows)], np.int32)
    pad_length = 16 - (ids.shape[1] % 16)
    if pad_length < 16:
        ids = np.concatenate([np.full((ids.shape[0], pad_length), pad_id, np.int32), ids], axis=1)
    return ids


class TextEncoder(nn.Module):
    def __init__(self, config: Optional[GlmConfig] = None, tokenizer=None):
        super().__init__()
        self.model = GlmModel(config or COGVIEW4_GLM_CONFIG)
        self.tokenizer = tokenizer

    def encode_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The penultimate hidden state of ``input_ids`` (unmasked)."""
        return self.model(input_ids, None)[1]

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

    def tokenize(self, prompts: list[str], max_token_length: int = DEFAULT_MAX_TOKEN_LENGTH):
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer configured for TextEncoder")
        return pad_token_ids(self.tokenizer, prompts, max_token_length)

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
        ids = self.tokenize(_prompts + _negatives, max_token_length)
        device = self.model.embed_tokens.weight.device
        hidden = self.encode_tokens(torch.from_numpy(ids).long().to(device))
        ones = torch.ones(ids.shape, dtype=torch.int32, device=device)
        return TextEncodingOutput(
            positive_embeddings=hidden[:n_pos],
            positive_attention_mask=ones[:n_pos],
            negative_embeddings=hidden[n_pos:],
            negative_attention_mask=ones[n_pos:],
        )
