"""State-dict key utilities (``vision_ft_tpu/utils/state_dict.py``
counterpart): include/exclude selection of keys by substring or regex, and
the OpenCLIP <-> transformers CLIP key and tensor conversions that sgm
single-file SDXL checkpoints need (the fused qkv split and joined along
the first axis). Values are torch tensors or numpy arrays."""

from __future__ import annotations

import re
from typing import Any, Sequence

import numpy as np
import torch
from pydantic import BaseModel


class RegexMatch(BaseModel):
    regex: str

    def __call__(self, value: str) -> bool:
        return bool(re.match(self.regex, value))


def get_target_keys(
    include: Sequence[str | RegexMatch],
    exclude: Sequence[str | RegexMatch],
    keys: list[str],
) -> list[str]:
    """Select keys matching any include pattern minus any exclude pattern.
    Strings match by substring; RegexMatch by ``re.match``."""
    matched: set[str] = set()
    for pattern in include:
        if isinstance(pattern, RegexMatch):
            compiled = re.compile(pattern.regex)
            matched.update(k for k in keys if compiled.match(k))
        else:
            matched.update(k for k in keys if pattern in k)
    for pattern in exclude:
        if isinstance(pattern, RegexMatch):
            compiled = re.compile(pattern.regex)
            matched.difference_update(k for k in keys if compiled.match(k))
        else:
            matched.difference_update(k for k in keys if pattern in k)
    return list(matched)


# -- OpenCLIP <-> transformers CLIP text-model conversion ------------------------

_OPENCLIP_TO_HF_RULES = [
    ("positional_embedding", "embeddings.position_embedding.weight"),
    ("token_embedding", "embeddings.token_embedding"),
    ("transformer.resblocks", "encoder.layers"),
    (".attn.", ".self_attn."),
    (".ln_1.", ".layer_norm1."),
    (".ln_2.", ".layer_norm2."),
    (".mlp.c_fc.", ".mlp.fc1."),
    (".mlp.c_proj.", ".mlp.fc2."),
    ("ln_final", "final_layer_norm"),
]


def _convert_key_open_clip_to_transformers(key: str) -> str:
    for src, dst in _OPENCLIP_TO_HF_RULES:
        key = key.replace(src, dst, 1)
    return key


def _convert_key_transformers_to_open_clip(key: str) -> str:
    for dst, src in _OPENCLIP_TO_HF_RULES:
        key = key.replace(src, dst, 1)
    return key


def _split3(value):
    if isinstance(value, torch.Tensor):
        return value.chunk(3, dim=0)
    return np.split(np.asarray(value), 3, axis=0)


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


def convert_open_clip_to_transformers(state_dict: dict[str, Any]) -> dict[str, Any]:
    """Rename OpenCLIP keys to transformers layout and split fused qkv."""
    renamed = {
        _convert_key_open_clip_to_transformers(k): v
        for k, v in state_dict.items()
        if "logit_scale" not in k
    }
    out: dict[str, Any] = {}
    for key, value in renamed.items():
        for fused, split_name in (("in_proj_weight", "weight"), ("in_proj_bias", "bias")):
            if key.endswith(fused):
                q, k_, v_ = _split3(value)
                out[key.replace(fused, f"q_proj.{split_name}")] = q
                out[key.replace(fused, f"k_proj.{split_name}")] = k_
                out[key.replace(fused, f"v_proj.{split_name}")] = v_
                break
        else:
            out[key] = value
    return out


def convert_transformers_to_open_clip(state_dict: dict[str, Any]) -> dict[str, Any]:
    """Inverse of :func:`convert_open_clip_to_transformers`."""
    out: dict[str, Any] = {}
    seen_bases: set[str] = set()
    for key, value in state_dict.items():
        m = re.search(r"(.*)\.(q|k|v)_proj\.(weight|bias)$", key)
        if m:
            base = m.group(1)
            if base in seen_bases:
                continue
            seen_bases.add(base)
            for fused, split_name in (("in_proj_weight", "weight"), ("in_proj_bias", "bias")):
                parts = [state_dict[f"{base}.{p}_proj.{split_name}"] for p in ("q", "k", "v")]
                out[_convert_key_transformers_to_open_clip(f"{base}.{fused}")] = _cat(parts)
        else:
            out[_convert_key_transformers_to_open_clip(key)] = value
    return out
