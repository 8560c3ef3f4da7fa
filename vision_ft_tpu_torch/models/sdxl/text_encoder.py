"""SDXL dual CLIP text encoder (``vision_ft_tpu/models/sdxl/text_encoder.py``
counterpart): CLIP-L penultimate hidden states + OpenCLIP-bigG penultimate
hidden states and projected pooled embedding, with long prompts chunked
into 75-token windows and the chunks concatenated.

- ``encode_tokens(ids1, ids2, batch)`` is the tensor core;
- ``encode_prompts(...)`` does the host-side part: string normalization,
  ``!`` escaping, tokenization, positive/negative split.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from ...modules.long_prompt import tokenize_long_prompt
from ...ops.attention import AttentionImplementation
from ..text_encoders import CLIPTextModel, CLIPTextModelWithProjection
from ..text_encoders.clip import SDXL_TEXT_ENCODER_1_CONFIG, SDXL_TEXT_ENCODER_2_CONFIG
from ..utils import PooledTextEncodingOutput, PromptType, TextEncodingOutput

CHUNK_LENGTH = 75  # CLIP window minus bos/eos


class MultipleTextEncodingOutput(NamedTuple):
    text_encoder_1: TextEncodingOutput
    text_encoder_2: PooledTextEncodingOutput


def _merge_chunks(hidden: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch*num_chunks, 77, d) -> (batch, 75*num_chunks + 2, d): drop the
    inner bos/eos, keep the first bos and the last eos."""
    _, seq, d = hidden.shape
    h = hidden.reshape(batch, -1, seq, d)
    inner = h[:, :, 1:-1, :].reshape(batch, -1, d)
    return torch.cat([h[:, 0, :1, :], inner, h[:, -1, -1:, :]], dim=1)


def _merge_mask_chunks(mask: torch.Tensor, batch: int) -> torch.Tensor:
    m = mask.reshape(batch, -1, mask.shape[-1])
    inner = m[:, :, 1:-1].reshape(batch, -1)
    return torch.cat([m[:, 0, :1], inner, m[:, -1, -1:]], dim=1)


class TextEncoder(nn.Module):
    """Holds both towers: keys ``text_encoder_1.*`` and ``text_encoder_2.*``."""

    def __init__(
        self,
        backend: AttentionImplementation = "xla",
        tokenizer=None,
        config_1=None,
        config_2=None,
    ):
        super().__init__()
        cfg1 = dataclasses.replace(config_1 or SDXL_TEXT_ENCODER_1_CONFIG, attention_backend=backend)
        cfg2 = dataclasses.replace(config_2 or SDXL_TEXT_ENCODER_2_CONFIG, attention_backend=backend)
        self.text_encoder_1 = CLIPTextModel(cfg1)
        self.text_encoder_2 = CLIPTextModelWithProjection(cfg2)
        # one shared CLIP tokenizer
        self.tokenizer = tokenizer

    def encode_tokens(self, input_ids_1: torch.Tensor, input_ids_2: torch.Tensor, batch: int):
        """ids: (batch*num_chunks, 77). Returns (emb1, emb2, pooled2), the
        embeddings chunk-merged to (batch, 75*num_chunks + 2, d)."""
        _, penult_1, _ = self.text_encoder_1(input_ids_1)
        _, penult_2, text_embeds = self.text_encoder_2(input_ids_2)
        emb1 = _merge_chunks(penult_1, batch)
        emb2 = _merge_chunks(penult_2, batch)
        # pooled: first chunk only
        pooled = text_embeds.reshape(batch, -1, text_embeds.shape[-1])[:, 0]
        return emb1, emb2, pooled

    @staticmethod
    def escape_exclamation(text: str) -> str:
        return text.replace("!", " !")

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
        return (
            [self.escape_exclamation(p) for p in _prompts],
            [self.escape_exclamation(p) for p in _negatives],
        )

    def encode_prompts(
        self,
        prompts: PromptType,
        negative_prompts: Optional[PromptType] = None,
        use_negative_prompts: bool = False,
        max_token_length: int = CHUNK_LENGTH,
    ) -> MultipleTextEncodingOutput:
        if self.tokenizer is None:
            raise RuntimeError(
                "No tokenizer configured. Pass tokenizer= to TextEncoder (e.g. "
                "CLIPTokenizer.from_pretrained_dir(path)) or call encode_tokens "
                "with pre-tokenized ids."
            )
        _prompts, _negatives = self.normalize_prompts(
            prompts, negative_prompts, use_negative_prompts
        )
        num_positive = len(_prompts)
        all_prompts = _prompts + _negatives
        batch = len(all_prompts)

        ids, mask = tokenize_long_prompt(
            self.tokenizer, all_prompts, max_length=max_token_length, chunk_length=CHUNK_LENGTH
        )
        device = next(self.parameters()).device
        ids = torch.from_numpy(ids).long().to(device)
        emb1, emb2, pooled = self.encode_tokens(ids, ids, batch)
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
