"""Host <-> card offloading of modules (``vision_ft_tpu/modules/offload.py``
counterpart).

The JAX package moves parameter trees with ``jax.device_put``; here a move
is ``.to(device)`` over a module or over the parameters and buffers whose
``named_parameters`` / ``named_buffers`` key starts with a prefix. A move
keeps each tensor's dtype (the uint8 / fp32 leaves of quantized weights
too: ``nn.QuantizedWeight`` moves them uncast) and the ``nn.Parameter``
objects themselves, which get new data. Moves are synchronous, as
``device_put`` is; a tensor parked on the host from the card lands in
pinned memory (PyTorch's caching host allocator, which keeps the blocks
for the next park), so both directions copy by DMA at the link's rate
instead of through a pageable bounce buffer. Shape-keyed launch plans
hold no weights, and every weight-derived tensor of the port's modules is
a parameter or a buffer, so nothing is left behind on the old device.

- :func:`move_params` / :func:`move_subtrees`: the moves themselves.
- :class:`LayerwiseOfflodStrategy` (the JAX package's spelling): layer
  groups of key prefixes; entering group i brings it to the execution
  device and parks group i - 1.
- :class:`OffloadableModuleMixin`: a strategy holder with ``on_device``.
- :func:`stage_on_device`: a ``generate()`` stage, a module on the card for
  its duration and parked after it; nothing when disabled.

The pipelines' ``generate(do_offloading=True)`` take the JAX stages: the
text encoder on the card to encode, then parked; the denoiser moved there
for the loop and parked after it; the VAE on the card for the decode, then
parked. Nothing is parked before the first stage, so the first offloaded
request peaks as high as a plain one and later ones start from the host.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence

import torch
from torch import nn

Device = torch.device | str


def _device(kind: Device) -> torch.device:
    """``"tpu"`` (the JAX package's name for the execution device) is the
    card; any other name or device is taken as it is."""
    return torch.device("cuda" if kind == "tpu" else kind)


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; into pinned host memory from the card."""
    if device.type == "cpu" and t.is_cuda:
        return torch.empty_like(t, device="cpu", pin_memory=True).copy_(t)
    return t.to(device)


def _move_tensors(module: nn.Module, device: torch.device, keep) -> None:
    """Move the parameters and buffers of ``module`` whose full key ``keep``
    accepts, each in place: a parameter keeps its object where the two
    devices' tensors allow it (the host's and the card's do), as
    ``nn.Module.to`` does."""
    # normal tensors even inside generate()'s inference mode, so that the
    # moved weights can still train
    with torch.inference_mode(False), torch.no_grad():
        for prefix, sub in module.named_modules(remove_duplicate=False):
            head = f"{prefix}." if prefix else ""
            for name, param in sub._parameters.items():
                if param is not None and keep(head + name) and param.device != device:
                    moved = _moved(param.data, device)
                    if torch._has_compatible_shallow_copy_type(param, moved):
                        param.data = moved  # the host's and the card's tensors are
                    else:
                        sub._parameters[name] = nn.Parameter(moved, param.requires_grad)
            for name, buf in sub._buffers.items():
                if buf is not None and keep(head + name) and buf.device != device:
                    sub._buffers[name] = _moved(buf, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def move_params(module: nn.Module, device: Device) -> nn.Module:
    """Every parameter and buffer of ``module`` to ``device`` (the
    counterpart of ``device_put`` on a whole tree); returns the module."""
    _move_tensors(module, _device(device), lambda key: True)
    return module


def move_subtrees(module: nn.Module, prefixes: Sequence[str], device: Device) -> nn.Module:
    """Only the parameters and buffers whose key starts with a prefix."""
    prefixes = tuple(prefixes)
    _move_tensors(module, _device(device), lambda key: key.startswith(prefixes))
    return module


class LayerwiseOfflodStrategy:  # the JAX package's spelling
    """Group-by-group streaming: at each group head, the previous group
    moves to the offload device and the current group to execution."""

    def __init__(
        self,
        layer_groups: Sequence[Sequence[str]],
        execution_device: Device = "cuda",
        offload_device: Device = "cpu",
    ):
        self.layer_groups = [list(g) for g in layer_groups]
        self.execution_device = _device(execution_device)
        self.offload_device = _device(offload_device)

    def group_index_of(self, key: str) -> Optional[int]:
        for i, group in enumerate(self.layer_groups):
            if any(key.startswith(p) for p in group):
                return i
        return None

    def offload_all(self, module: nn.Module) -> nn.Module:
        _move_tensors(module, self.offload_device, lambda key: self.group_index_of(key) is not None)
        return module

    def maybe_offload_by_group(self, module: nn.Module, group_idx: int) -> nn.Module:
        """Bring group ``group_idx`` to the execution device and park the
        previous group."""
        current = tuple(self.layer_groups[group_idx])
        previous = tuple(self.layer_groups[group_idx - 1]) if group_idx > 0 else ()
        _move_tensors(module, self.execution_device, lambda key: key.startswith(current))
        if previous:
            _move_tensors(module, self.offload_device,
                          lambda key: key.startswith(previous) and not key.startswith(current))
        return module


class OffloadableModuleMixin:
    """A strategy holder with ``maybe_offload_by_group`` and ``on_device``
    over a module."""

    offload_strategy: Optional[LayerwiseOfflodStrategy] = None

    def set_offload_strategy(self, strategy: Optional[LayerwiseOfflodStrategy]) -> None:
        self.offload_strategy = strategy

    def maybe_offload_by_group(self, module: nn.Module, group_idx: int) -> nn.Module:
        if self.offload_strategy is None:
            return module
        return self.offload_strategy.maybe_offload_by_group(module, group_idx)

    @contextmanager
    def on_device(self, module: nn.Module, device: Device = "cuda"):
        """``module`` on ``device`` for the block, then back on the offload
        device where a strategy is set."""
        move_params(module, device)
        try:
            yield module
        finally:
            if self.offload_strategy is not None:
                move_params(module, self.offload_strategy.offload_device)


@contextmanager
def stage_on_device(module: nn.Module, enabled: bool, execution: Device = "cuda",
                    offload: Device = "cpu"):
    """A ``generate()`` stage: ``module`` on the execution device for the
    block, then parked on the offload device. Nothing at all when
    ``enabled`` is False."""
    if not enabled:
        yield
        return
    move_params(module, execution)
    try:
        yield
    finally:
        move_params(module, offload)


def execution_device(model) -> torch.device:
    """Where a pipeline's offloaded stages run: the device of its weights at
    its first offloaded request (every part is there then), remembered on
    the pipeline."""
    device = model.__dict__.get("_offload_execution_device")
    if device is None:
        device = model.__dict__["_offload_execution_device"] = torch.device(model.device)
    return device
