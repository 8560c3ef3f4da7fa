"""Safetensors I/O for torch tensors (``vision_ft_tpu/utils/safetensors.py``
counterpart), through the ``safetensors`` package: the interchange format
of both packages, with the same keys."""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import torch


def load_file(
    path: str | os.PathLike, dtype: Optional[torch.dtype] = None, device: str = "cpu"
) -> dict[str, torch.Tensor]:
    """Load a safetensors file into tensors on ``device``; ``dtype`` casts
    every floating tensor on load."""
    from safetensors.torch import load_file as _load_file

    out = _load_file(str(path), device=str(device))
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() else v for k, v in out.items()}
    return out


def read_keys(path: str | os.PathLike) -> list[str]:
    """Tensor names in a safetensors file without loading any data: the
    8-byte little-endian header length, then a JSON header."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return [k for k in header.keys() if k != "__metadata__"]


def save_file(
    tensors: dict[str, torch.Tensor], path: str | os.PathLike,
    metadata: Optional[dict[str, str]] = None,
) -> None:
    """Write ``tensors`` (moved to the host, made contiguous) to ``path``."""
    from safetensors.torch import save_file as _save_file

    tensors = {k: torch.as_tensor(v).detach().to("cpu").contiguous() for k, v in tensors.items()}
    _save_file(tensors, str(path), metadata=metadata)


def load_file_with_rename_key_map(
    path: str | os.PathLike, rename_key_map: Optional[dict[str, str]] = None,
    dtype: Optional[torch.dtype] = None,
) -> dict[str, torch.Tensor]:
    """Load and apply substring renames."""
    state_dict = load_file(path, dtype=dtype)
    if not rename_key_map:
        return state_dict
    renamed = {}
    for key, value in state_dict.items():
        for src, dst in rename_key_map.items():
            key = key.replace(src, dst)
        renamed[key] = value
    return renamed
