"""JAX parameters -> port modules.

``load_flat_params`` takes the JAX package's parameters as numpy arrays,
keyed as ``vision_ft_tpu.nn.core.flatten_params`` keys them, and loads
them into a port module. Linear weights are (out, in) and conv weights
OIHW in both packages, so every tensor is a straight copy: no transpose
anywhere. Only the dtype is converted, to the dtype of the module's own
parameter (numpy has no bfloat16, so ``ml_dtypes`` bfloat16 arrays are
reinterpreted bit for bit).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


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
        tensors[key] = value.to(device=device, dtype=target.dtype)
    module.load_state_dict(tensors, strict=strict, assign=True)
    return module
