"""dtype-name parsing (``vision_ft_tpu/utils/dtype.py`` counterpart)."""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float": torch.float32,
}


def str_to_dtype(dtype: str) -> torch.dtype:
    try:
        return _DTYPES[dtype.lower()]
    except KeyError:
        raise ValueError(f"Unknown dtype: {dtype}") from None
