"""A learnable 0 -> 1 migration blend (``vision_ft_tpu/modules/migration/
scale.py`` counterpart): the RoPE migration workload blends the learned
positional encoding toward RoPE through it. The scale starts at zero and
trains toward one; once |1 - scale| is below ``freezing_threshold`` the
blend takes ones, detached, in its place. Loading a checkpoint re-zeroes
it (:meth:`rezero`), as the JAX package's checkpoint hook does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MigrationScaleFromZero(nn.Module):
    def __init__(self, dim: int = 1, freezing_threshold: Optional[float] = None):
        super().__init__()
        self.dim = dim
        self.freezing_threshold = freezing_threshold
        self.scale = nn.Parameter(torch.zeros(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Zeros: the scale's only init (the generator is not drawn from)."""
        self.scale.zero_()

    def inner_scale(self) -> torch.Tensor:
        """The live scale in fp32, or ones (no gradient) once every entry is
        within the freezing threshold of one. The test runs on the device,
        as a ``where``, with no sync to the host."""
        scale = self.scale.float()
        if self.freezing_threshold is None:
            return scale
        frozen = torch.max(torch.abs(1.0 - scale)) < self.freezing_threshold
        return torch.where(frozen, torch.ones_like(scale), scale)

    def scale_positive(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.inner_scale().to(x.dtype)

    def scale_negative(self, x: torch.Tensor) -> torch.Tensor:
        return x * (1.0 - self.inner_scale()).to(x.dtype)

    def forward(self, old_value: torch.Tensor, new_value: torch.Tensor) -> torch.Tensor:
        """old * (1 - s) + new * s."""
        return self.scale_negative(old_value) + self.scale_positive(new_value)

    @torch.no_grad()
    def rezero(self) -> None:
        """The checkpoint-load hook: the scale back to zero, in place."""
        self.scale.zero_()
