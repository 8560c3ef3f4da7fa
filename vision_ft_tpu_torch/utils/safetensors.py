"""Safetensors I/O for torch tensors (``vision_ft_tpu/utils/safetensors.py``
counterpart): the interchange format of both packages, with the same keys,
read through the ``safetensors`` package and written by a streaming writer
of the package's own layout."""

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


# the format's dtype names, in the order of its dtype enum: the safetensors
# library lays tensors out by that order, last first, then by name
_DTYPE_NAMES = {
    torch.bool: "BOOL", torch.uint8: "U8", torch.int8: "I8", torch.float8_e5m2: "F8_E5M2",
    torch.float8_e4m3fn: "F8_E4M3", torch.int16: "I16", torch.uint16: "U16",
    torch.float16: "F16", torch.bfloat16: "BF16", torch.int32: "I32", torch.uint32: "U32",
    torch.float32: "F32", torch.float64: "F64", torch.int64: "I64", torch.uint64: "U64",
}
_DTYPE_RANK = {dtype: i for i, dtype in enumerate(_DTYPE_NAMES)}
_STAGING_BYTES = 256 * 2**20


def save_file(
    tensors: dict[str, torch.Tensor], path: str | os.PathLike,
    metadata: Optional[dict[str, str]] = None,
) -> None:
    """Write ``tensors`` to ``path``: the bytes ``safetensors.torch.save_file``
    writes for their host copies, streamed. A device tensor reaches the file
    through one pinned host buffer and a host tensor from its own memory,
    so the host never holds a copy of the whole state."""
    items = sorted(((k, torch.as_tensor(v).detach()) for k, v in tensors.items()),
                   key=lambda kv: (-_DTYPE_RANK[kv[1].dtype], kv[0]))
    header, offset = {}, 0
    if metadata is not None:
        header["__metadata__"] = metadata
    for k, v in items:
        n = v.numel() * v.element_size()
        header[k] = {"dtype": _DTYPE_NAMES[v.dtype], "shape": list(v.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    raw += b" " * (-len(raw) % 8)
    staging = None
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, v in items:
            flat = v.contiguous().reshape(-1).view(torch.uint8)
            if flat.device.type == "cpu":
                f.write(memoryview(flat.numpy()))
                continue
            if staging is None:
                staging = torch.empty(_STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
            for i in range(0, flat.numel(), _STAGING_BYTES):
                part = staging[:min(_STAGING_BYTES, flat.numel() - i)]
                part.copy_(flat[i:i + part.numel()])
                f.write(memoryview(part.numpy()))


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
