"""Mask generators for fractal masked-autoregressive training
(``vision_ft_tpu/models/fractal/mask.py`` counterpart). Each draws from an
explicit ``torch.Generator``; ``masks`` is the deterministic part, which
takes the draws (so that a caller can feed it the JAX package's)."""

from __future__ import annotations

import math

import torch


def _ranks(orders: torch.Tensor) -> torch.Tensor:
    """position -> its rank in the order"""
    return torch.argsort(orders, dim=-1)


class UniformMaskGenerator:
    """Mask the first k positions of a random order, k ~ U[1, seq]. As in
    the JAX package each row masks its own k (the upstream code indexes
    with a per-batch tensor, which uses its first element only)."""

    def __call__(self, generator: torch.Generator, patches: torch.Tensor,
                 orders: torch.Tensor) -> torch.Tensor:
        batch_size, seq_len = orders.shape
        k = torch.randint(1, seq_len + 1, (batch_size, 1), generator=generator,
                          device=generator.device).to(orders.device)
        return self.masks(orders, k)

    @staticmethod
    def masks(orders: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """(B, S) fp32 mask, 1 at the first ``k`` (B, 1) positions of each
        order."""
        return (_ranks(orders) < k).to(torch.float32)


class TruncatedNormalMaskGenerator:
    """Mask rate ~ TruncNormal(mean 1, std, [0, 1]); the first
    ceil(rate * seq) positions of the order are masked."""

    def __init__(self, std: float = 0.25):
        self.std = std

    def __call__(self, generator: torch.Generator, patches: torch.Tensor,
                 orders: torch.Tensor) -> torch.Tensor:
        batch_size = orders.shape[0]
        # a standard normal truncated to [-1 / std, 0], by its inverse CDF
        lower = 0.5 * (1.0 + math.erf(-1.0 / self.std / math.sqrt(2.0)))
        u = torch.rand(batch_size, generator=generator, device=generator.device)
        z = torch.special.ndtri(lower + (0.5 - lower) * u).clamp(-1.0 / self.std, 0.0)
        return self.masks(orders, z.to(orders.device))

    def masks(self, orders: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """(B, S) bool mask from the standard truncated-normal draws ``z``
        (B,): rate 1 + std z, ceil(rate * seq) positions of each order."""
        rates = 1.0 + self.std * z.to(torch.float32)
        num_masked = torch.ceil(rates * orders.shape[1])
        return _ranks(orders) < num_masked[:, None]
