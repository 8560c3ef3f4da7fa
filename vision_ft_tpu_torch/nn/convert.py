"""JAX parameters -> port modules.

``load_flat_params`` takes the JAX package's parameters as numpy arrays,
keyed as ``vision_ft_tpu.nn.core.flatten_params`` keys them, and loads
them into a port module. Linear weights are (out, in) and conv weights
OIHW in both packages, so every tensor is a straight copy: no transpose
anywhere. Only the dtype is converted, to the dtype of the module's own
parameter (numpy has no bfloat16, so ``ml_dtypes`` bfloat16 arrays are
reinterpreted bit for bit).

Adapter keys (``lora_down.weight``, ``lora_up.weight``, ``alpha``,
``hada_*``) are accepted too: the adapters they describe are attached to
the module's layers first. ``load_peft_state`` takes the JAX package's
``(trainable, frozen)`` split, flattened, and also carries the split over
as ``requires_grad``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .core import attach_adapters_from_state, is_adapter_key

# leaves of a quantized weight subtree (modules/quant of the JAX package)
_QUANT_KEY = re.compile(r"(^|\.)weight\.(packed|data|_meta|absmax|code|scale|split)$")


def _to_tensor(value) -> torch.Tensor:
    arr = np.array(value)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@torch.no_grad()
def load_flat_params(
    module: nn.Module, flat: Mapping[str, np.ndarray], strict: bool = True
) -> nn.Module:
    """Load ``flat`` into ``module`` in place and return it.

    Raises ``KeyError`` on a missing or unexpected key (``strict``) and
    ``ValueError`` on a shape mismatch. Each tensor lands on the device of
    the parameter it replaces, or on the CPU where that parameter is on
    the meta device.
    """
    quantized = [k for k in flat if _QUANT_KEY.search(k)]
    if quantized:
        raise NotImplementedError(
            f"quantized weight subtrees (NF4, fp8, int8_w8a8) are not ported: {quantized[0]}"
        )
    own = module.state_dict(keep_vars=True)
    adapters = {k: _to_tensor(v) for k, v in flat.items() if is_adapter_key(k) and k not in own}
    if adapters:
        attach_adapters_from_state(module, adapters)
        own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if strict and (missing or unexpected):
        raise KeyError(
            f"missing keys {missing[:5]} ({len(missing)}), "
            f"unexpected keys {unexpected[:5]} ({len(unexpected)})"
        )
    tensors = {}
    for key in own.keys() & flat.keys():
        target = own[key]
        value = _to_tensor(flat[key])
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{key}: shape {tuple(value.shape)} does not match {tuple(target.shape)}"
            )
        device = "cpu" if target.is_meta else target.device
        # a new adapter keeps the dtype it comes in; everything else takes
        # the dtype of the parameter it replaces
        dtype = value.dtype if key in adapters else target.dtype
        tensors[key] = value.to(device=device, dtype=dtype)
    module.load_state_dict(tensors, strict=strict, assign=True)
    return module


def load_peft_state(
    module: nn.Module,
    trainable: Mapping[str, np.ndarray],
    frozen: Mapping[str, np.ndarray],
) -> nn.Module:
    """Load the JAX package's ``split_peft_params`` trees, each flattened to
    numpy arrays, into ``module``: adapters are attached where ``trainable``
    names them, every tensor is loaded, and ``requires_grad`` is set true on
    exactly the parameters ``trainable`` holds."""
    load_flat_params(module, {**frozen, **trainable})
    for key, param in module.named_parameters():
        param.requires_grad_(key in trainable)
    return module
