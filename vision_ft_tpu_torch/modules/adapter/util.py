"""Adapter framework (``vision_ft_tpu/modules/adapter/util.py``
counterpart).

The module swap is static: an adapter model builds its denoiser with an
adapter attention class. The manager maps the adapter parameters between
the live modules (``...attn2.to_k_ip.weight``) and the on-disk layout
(``ip_adapter.{2 * i + 1}.to_k_ip.weight``, the i-th targeted attn2 in
replacement order).
"""

from __future__ import annotations

from abc import ABC
from typing import Mapping, Sequence

import torch
from pydantic import BaseModel
from torch import nn

from ...utils.state_dict import RegexMatch


class Adapter(ABC):
    """Marker base for adapter attention modules."""

    target_key: RegexMatch
    # parameter subtrees the adapter owns (e.g. to_k_ip, to_v_ip)
    adapter_param_names: Sequence[str] = ()


class AdapterManager:
    """Maps adapter parameters between module paths and on-disk keys.

    ``target_paths``: the targeted module paths (relative to the module
    handed to :meth:`get_state_dict` / :meth:`load_state_dict`) in
    replacement order; adapter i is stored under ``ip_adapter.{2*i + 1}.``."""

    disk_prefix: str = "ip_adapter"

    def __init__(self, adapter_class: type[Adapter], adapter_config: BaseModel):
        self.adapter_class = adapter_class
        self.adapter_config = adapter_config
        self.target_paths: list[str] = []

    def set_target_paths(self, paths: Sequence[str]) -> None:
        self.target_paths = list(paths)

    def _disk_key(self, index: int, suffix: str) -> str:
        return f"{self.disk_prefix}.{index * 2 + 1}.{suffix}"

    def get_state_dict(self, module: nn.Module) -> dict[str, torch.Tensor]:
        """The adapters' tensors of ``module`` under their on-disk keys."""
        flat = module.state_dict()
        out = {}
        for i, path in enumerate(self.target_paths):
            prefix = f"{path}."
            for key, value in flat.items():
                if key.startswith(prefix):
                    suffix = key[len(prefix):]
                    if suffix.split(".")[0] in self.adapter_class.adapter_param_names:
                        out[self._disk_key(i, suffix)] = value
        return out

    def load_state_dict(self, module: nn.Module, state_dict: Mapping[str, object]) -> None:
        """Copy on-disk adapter tensors into ``module``'s adapters, in place
        (each in its parameter's dtype and device); a key that names no
        tensor of the module raises ``KeyError``."""
        own = module.state_dict(keep_vars=True)
        for i, path in enumerate(self.target_paths):
            prefix = f"{self.disk_prefix}.{i * 2 + 1}."
            for key, value in state_dict.items():
                if not key.startswith(prefix):
                    continue
                target = f"{path}.{key[len(prefix):]}"
                if target not in own:
                    raise KeyError(f"{key!r} names no tensor of the model ({target!r})")
                with torch.no_grad():
                    own[target].copy_(torch.as_tensor(value))
