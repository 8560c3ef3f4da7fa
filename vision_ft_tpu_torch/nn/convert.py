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
the module's layers first. So are the leaves of quantized weights
(``X.weight.packed``, ``.absmax``, ``.code``, ``._meta``, ``.split``,
``.data``, ``.scale``, ``.SCB``, ``.shift``, ``.w8a8``, or an fp8
``X.weight``): the ``Linear`` they name gets a quantized weight, and every
leaf keeps the dtype it comes in (``ml_dtypes`` fp8 arrays are
reinterpreted bit for bit, like bfloat16).
``load_peft_state`` takes the JAX package's
``(trainable, frozen)`` split, flattened, and also carries the split over
as ``requires_grad``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

from .core import FP8_DTYPES, Linear, attach_adapters_from_state, is_adapter_key, weight_device

# leaves of a quantized weight subtree (modules/quant of the JAX package)
_QUANT_KEY = re.compile(
    r"^(?:(.*)\.)?weight\.(packed|data|_meta|absmax|code|scale|split|SCB|shift|w8a8)$"
)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def _to_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    arr = np.array(value)  # a writable copy: JAX hands out read-only buffers
    if arr.dtype.name in _BIT_VIEWS:
        bits, dtype = _BIT_VIEWS[arr.dtype.name]
        return torch.from_numpy(arr.view(bits)).view(dtype)
    return torch.from_numpy(arr)


def _install_quantized_weights(
    module: nn.Module, flat: Mapping[str, torch.Tensor], meta_device: torch.device | str
) -> set[str]:
    """Give every ``Linear`` that ``flat`` holds quantized leaves or an fp8
    weight for a quantized weight made of them, on the layer's device
    (``meta_device`` for a layer on the meta device). Returns the keys it
    took."""
    layers = dict(module.named_modules())
    grouped: dict[str, dict[str, torch.Tensor]] = {}
    for key, value in flat.items():
        match = _QUANT_KEY.match(key)
        if match:
            grouped.setdefault(match.group(1) or "", {})[match.group(2)] = value
        elif key.endswith("weight") and value.dtype in FP8_DTYPES:
            grouped[key[: -len("weight")].rstrip(".")] = value
    taken = set()
    for root, quantized in grouped.items():
        layer = layers.get(root)
        if not isinstance(layer, Linear):
            raise KeyError(f"quantized weight of {root!r} has no Linear to go on")
        device = weight_device(layer)
        device = meta_device if device.type == "meta" else device
        shape = (layer.out_features, layer.in_features)
        numel = shape[0] * shape[1]
        if isinstance(quantized, torch.Tensor):
            sized = tuple(quantized.shape) == shape
        else:
            if "packed" in quantized:
                needed, optional = {"packed", "absmax", "code", "_meta"}, {"split"}
            elif "SCB" in quantized:
                needed, optional = {"data", "SCB"}, set()
            else:
                needed, optional = {"data", "scale"}, {"shift", "w8a8"}
            missing = sorted(needed - set(quantized))
            unexpected = sorted(set(quantized) - needed - optional)
            if missing or unexpected:
                raise KeyError(
                    f"{root}.weight: missing keys {missing}, unexpected keys {unexpected} "
                    "among the leaves of a quantized weight"
                )
            if "packed" in quantized:
                # exactly the codes, or bnb's flat padding to a 64-element block
                sized = quantized["packed"].numel() in ((numel + 1) // 2, -(-numel // 64) * 32)
            else:
                sized = quantized["data"].numel() == (numel // 2 if "shift" in quantized else numel)
        if not sized:
            raise ValueError(f"{root}: quantized weight does not match the layer's shape {shape}")
        if isinstance(quantized, torch.Tensor):
            layer.set_quantized_weight(quantized.to(device), root)
            taken.add(f"{root}.weight" if root else "weight")
        else:
            layer.set_quantized_weight({k: v.to(device) for k, v in quantized.items()}, root)
            taken.update(f"{root}.weight.{k}" if root else f"weight.{k}" for k in quantized)
    return taken


@torch.no_grad()
def load_flat_params(
    module: nn.Module, flat: Mapping[str, np.ndarray], strict: bool = True,
    meta_device: torch.device | str = "cpu",
) -> nn.Module:
    """Load ``flat`` into ``module`` in place and return it.

    Raises ``KeyError`` on a missing or unexpected key (``strict``) and
    ``ValueError`` on a shape mismatch. Each tensor lands on the device of
    the parameter it replaces, or on ``meta_device`` where that parameter
    is on the meta device.
    """
    flat = {k: _to_tensor(v) for k, v in flat.items()}
    own = module.state_dict(keep_vars=True)
    adapters = {k: v for k, v in flat.items() if is_adapter_key(k) and k not in own}
    if adapters:
        attach_adapters_from_state(module, adapters)
    quantized = _install_quantized_weights(module, flat, meta_device)
    if adapters or quantized:
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
        value = flat[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"{key}: shape {tuple(value.shape)} does not match {tuple(target.shape)}"
            )
        device = meta_device if target.is_meta else target.device
        # a new adapter and a quantized leaf keep the dtype they come in;
        # everything else takes the dtype of the parameter it replaces
        dtype = value.dtype if key in adapters or key in quantized else target.dtype
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
