"""Shared norms (``vision_ft_tpu/modules/norm.py`` counterpart).

FP32LayerNorm / FP32RMSNorm are the ``nn.core`` norms (both compute in
fp32); SingleAdaLayerNormZero is the zero-initialized adaLN head of the
IP-Adapter's adaln_zero variant.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import LayerNorm as FP32LayerNorm
from ..nn import Linear
from ..nn import RMSNorm as FP32RMSNorm


class SingleAdaLayerNormZeroOutput(NamedTuple):
    hidden_states: torch.Tensor
    scale: torch.Tensor
    shift: torch.Tensor
    gate: torch.Tensor


class SingleAdaLayerNormZero(nn.ModuleDict):
    """fp32 LayerNorm without affine, then scale / shift and a gate from
    the time embedding, both heads zero-initialized."""

    def __init__(self, hidden_dim: int, gate_dim: int, embedding_dim: int):
        super().__init__(
            {
                "scale_shift": Linear(embedding_dim, 2 * hidden_dim),
                "gate": Linear(embedding_dim, gate_dim),
            }
        )
        self.norm = FP32LayerNorm(hidden_dim, eps=1e-6, elementwise_affine=False)

    @torch.no_grad()
    def zero_(self) -> "SingleAdaLayerNormZero":
        """The zero init of both heads (the JAX ``init``)."""
        for name in ("scale_shift", "gate"):
            self[name].weight.zero_()
            self[name].bias.zero_()
        return self

    def forward(self, hidden_states, time_embed) -> SingleAdaLayerNormZeroOutput:
        normed = self.norm(hidden_states)
        t = F.silu(time_embed)
        scale, shift = self["scale_shift"](t).chunk(2, dim=1)
        gate = self["gate"](t)
        out = normed * (1 + scale[:, None, :]) + shift[:, None, :]
        return SingleAdaLayerNormZeroOutput(out.to(hidden_states.dtype), scale, shift, gate)


__all__ = [
    "FP32LayerNorm",
    "FP32RMSNorm",
    "SingleAdaLayerNormZero",
    "SingleAdaLayerNormZeroOutput",
]
