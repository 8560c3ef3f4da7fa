"""Random generation orders (``vision_ft_tpu/models/fractal/order_sampler.py``
counterpart)."""

from __future__ import annotations

from typing import Optional

import torch


def sample_order(generator: torch.Generator, batch_size: int, sequence_length: int,
                 device: Optional[torch.device | str] = None) -> torch.Tensor:
    """(batch, seq) random permutations: the argsort of uniforms drawn from
    ``generator`` (on its device unless ``device`` names another)."""
    device = generator.device if device is None else device
    u = torch.rand(batch_size, sequence_length, generator=generator, device=device)
    return torch.argsort(u, dim=-1)
