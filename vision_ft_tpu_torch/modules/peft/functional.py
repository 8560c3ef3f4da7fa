"""PEFT transformations over modules
(``vision_ft_tpu/modules/peft/functional.py`` counterpart).

  replace_to_peft_layer  add zero-delta adapters to the targeted layers
  get_adapter_parameters flat kohya-layout adapter state dict
  split_peft_params      set requires_grad; (trainable, frozen) named tensors
  merge_params           trainable over frozen, one flat dict
  load_peft_weight       attach the adapters of a flat adapter state dict

Adapter leaf names (lora_down/lora_up/alpha, hada_w1_a..) and init rules
(kaiming-uniform down, zero up; LoHa normal/zero) are the JAX package's.
Every function works on the module in place and returns it, where the JAX
functions return new param trees.
"""

from __future__ import annotations

import math
import warnings
from contextlib import contextmanager
from typing import Callable, Mapping, NamedTuple, Sequence

import torch
from torch import nn

from ...nn.core import (
    Conv2d,
    Linear,
    attach_adapter,
    attach_adapters_from_state,
    is_adapter_key,
    set_peft_enabled,
    weight_device,
)
from ...utils.dtype import str_to_dtype
from ...utils.state_dict import RegexMatch, get_target_keys


def find_targetable_paths(module: nn.Module) -> list[str]:
    """Paths of the Linear and Conv2d layers of ``module``."""
    return [name for name, m in module.named_modules() if isinstance(m, (Linear, Conv2d))]


def _uniform(shape, bound, dtype, device, generator):
    # drawn in fp32 on the generator's device, then cast and moved
    draw = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return draw.uniform_(-bound, bound, generator=generator).to(device=device, dtype=dtype)


def _normal(shape, std, dtype, device, generator):
    draw = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return draw.normal_(0.0, std, generator=generator).to(device=device, dtype=dtype)


def _init_lora(layer, config, dtype, device, generator) -> dict[str, torch.Tensor]:
    rank = config.rank
    if isinstance(layer, Linear):
        out_f, in_f = layer.out_features, layer.in_features
        down_shape, up_shape, fan_in = (rank, in_f), (out_f, rank), in_f
    else:  # conv OIHW
        out_f, in_f, ks = layer.out_channels, layer.in_channels, layer.kernel_size
        down_shape, up_shape, fan_in = (rank, in_f, ks, ks), (out_f, rank, 1, 1), in_f * ks * ks
    # torch kaiming_uniform_ (a=0, fan_in, gain sqrt(2)): U(+-sqrt(6/fan_in))
    bound = math.sqrt(6.0 / fan_in)
    adapter = {
        "lora_down.weight": _uniform(down_shape, bound, dtype, device, generator),
        "lora_up.weight": torch.zeros(up_shape, dtype=dtype, device=device),
        "alpha": torch.tensor(config.alpha, dtype=dtype, device=device),
    }
    if getattr(config, "use_bias", False):
        adapter["lora_up.bias"] = torch.zeros((out_f,), dtype=dtype, device=device)
    return adapter


def _init_loha(layer, config, dtype, device, generator) -> dict[str, torch.Tensor]:
    out_f, in_f, rank = layer.out_features, layer.in_features, config.rank
    # w1_b ~ N(0,1), w1_a ~ N(0,0.1^2), w2_b ~ N(0,1), w2_a = 0, so the
    # initial delta is zero
    return {
        "hada_w1_a": _normal((in_f, rank), 0.1, dtype, device, generator),
        "hada_w1_b": _normal((rank, out_f), 1.0, dtype, device, generator),
        "hada_w2_a": torch.zeros((in_f, rank), dtype=dtype, device=device),
        "hada_w2_b": _normal((rank, out_f), 1.0, dtype, device, generator),
        "alpha": torch.tensor(config.alpha, dtype=dtype, device=device),
    }


@torch.no_grad()
def replace_to_peft_layer(
    module: nn.Module,
    include_keys: Sequence[str | RegexMatch],
    exclude_keys: Sequence[str | RegexMatch],
    config,
    generator: torch.Generator,
    dtype=None,
) -> nn.Module:
    """Add zero-delta adapters to every targeted Linear/Conv2d of
    ``module``, in place. The adapters land on each layer's device (on the
    generator's device where the layer is still on the meta device), in
    ``dtype`` (default: the config's)."""
    dtype = dtype or str_to_dtype(config.dtype)
    if config.type not in ("lora", "loha"):
        raise ValueError(f"Unknown peft type: {config.type}")
    layers = dict(module.named_modules())
    targets = sorted(get_target_keys(include_keys, exclude_keys, find_targetable_paths(module)))
    if not targets:
        warnings.warn("PEFT targeting matched no layers — check include_keys")
    for target in targets:
        layer = layers[target]
        device = weight_device(layer)
        if device.type == "meta":
            device = generator.device
        # LoHa is for Linear layers; a targeted conv gets conv LoRA
        init = _init_loha if config.type == "loha" and isinstance(layer, Linear) else _init_lora
        attach_adapter(layer, init(layer, config, dtype, device, generator))
    return module


# -- collection / splitting --------------------------------------------------


def get_adapter_parameters(module: nn.Module) -> dict[str, torch.Tensor]:
    """Flat kohya-layout adapter state dict."""
    return {k: v for k, v in module.state_dict().items() if is_adapter_key(k)}


def split_peft_params(
    module: nn.Module,
) -> tuple[dict[str, nn.Parameter], dict[str, torch.Tensor]]:
    """(trainable, frozen), keyed like ``state_dict()``: adapter weights
    train, the base and ``alpha`` stay frozen. Sets ``requires_grad``
    accordingly, so the frozen base gets no gradient and no weight-gradient
    product."""
    trainable: dict[str, nn.Parameter] = {}
    frozen: dict[str, torch.Tensor] = {}
    for key, value in module.state_dict(keep_vars=True).items():
        if is_adapter_key(key) and key.split(".")[-1] != "alpha":
            value.requires_grad_(True)
            trainable[key] = value
        else:
            if isinstance(value, nn.Parameter):
                value.requires_grad_(False)
            frozen[key] = value
    return trainable, frozen


def merge_params(
    frozen: Mapping[str, torch.Tensor], trainable: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """One flat state dict, trainable over frozen. A module of the port
    holds both already; this rebuilds what ``state_dict()`` would give."""
    return {**frozen, **trainable}


# -- loading -----------------------------------------------------------------


def detect_peft_method(state_dict: Mapping[str, object]) -> str:
    if any(name.endswith(".lora_up.weight") for name in state_dict):
        return "lora"
    if any(".hada_w1_a" in name for name in state_dict):
        return "loha"
    return "none"


@torch.no_grad()
def load_peft_weight(module: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> nn.Module:
    """Attach the adapters of a flat adapter state dict to ``module``, each
    on its layer's device (where it was, for a layer on the meta device). A
    key whose base layer does not exist is an error."""
    if detect_peft_method(state_dict) == "none":
        raise ValueError("Failed to detect peft method from state_dict")
    stray = [key for key in state_dict if not is_adapter_key(key)]
    if stray:
        raise KeyError(f"adapter weight {stray[0]!r} has no base layer {stray[0]!r}")
    attach_adapters_from_state(module, state_dict)
    return module


# -- reporting ---------------------------------------------------------------


class TrainableParameters(NamedTuple):
    trainable_params: int
    all_param: int
    trainable_percent: float


def calculate_trainable_parameters(module: nn.Module) -> TrainableParameters:
    """Counts by the split rule (adapter weights train), whatever
    ``requires_grad`` says now."""
    n_train = n_all = 0
    for key, value in module.state_dict().items():
        n_all += value.numel()
        if is_adapter_key(key) and key.split(".")[-1] != "alpha":
            n_train += value.numel()
    return TrainableParameters(n_train, n_all, 100.0 * n_train / max(n_all, 1))


def human_readable_param(param_size: int) -> str:
    for unit, value in (("T", 10**12), ("B", 10**9), ("M", 10**6), ("K", 10**3)):
        if param_size >= value:
            return f"{param_size / value:.2f}{unit}"
    return str(param_size)


def print_trainable_parameters(module: nn.Module, print_fn: Callable = print) -> None:
    stats = calculate_trainable_parameters(module)
    print_fn(
        f"Trainable params: {human_readable_param(stats.trainable_params)}, "
        f"All params: {human_readable_param(stats.all_param)}, "
        f"Trainable%: {stats.trainable_percent:.4f}%"
    )
    if stats.trainable_params == 0:
        warnings.warn("No trainable parameters found — check your peft config")


# -- enable/disable ----------------------------------------------------------


@contextmanager
def while_peft_disabled():
    """Adapters are skipped inside this context."""
    try:
        set_peft_enabled(False)
        yield
    finally:
        set_peft_enabled(True)


@contextmanager
def while_peft_enabled():
    try:
        set_peft_enabled(True)
        yield
    finally:
        set_peft_enabled(False)
