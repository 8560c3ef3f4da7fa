"""Sinusoidal timestep embeddings (diffusers-compatible), as the JAX
``modules/timestep/embedding.py`` computes them, in fp32, and the MLP
over them (``TimestepEmbedding``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...nn import Linear


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 1.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """(N,) fractional timesteps -> (N, embedding_dim) fp32 sinusoids."""
    if timesteps.ndim != 1:
        raise ValueError("Timesteps should be a 1d-array")
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(torch.nn.Module):
    """linear_1 -> silu -> linear_2 MLP over a sinusoid embedding."""

    def __init__(self, in_channels: int, time_embed_dim: int, bias: bool = True):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim, bias=bias)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))
