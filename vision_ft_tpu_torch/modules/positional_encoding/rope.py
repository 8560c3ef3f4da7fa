"""Flux-style multi-axis RoPE (``vision_ft_tpu/modules/positional_encoding/
rope.py`` counterpart): per-axis cos/sin tables from (axis0, y, x) position
indices, computed in fp64 on the host and kept in fp32; an fp32 even/odd
rotation of q and k. Text tokens take all-zero positions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def image_position_indices(
    height: int, width: int, rope_dim: int = 3, y_index: int = 1, x_index: int = 2
) -> np.ndarray:
    """(h/2 * w/2, rope_dim) of (0, y, x) patch positions; height and width
    are latent sizes, positions are per 2x2 patch."""
    h, w = height // 2, width // 2
    pos = np.zeros((h, w, rope_dim), dtype=np.float32)
    pos[..., y_index] += np.arange(h, dtype=np.float32)[:, None]
    pos[..., x_index] += np.arange(w, dtype=np.float32)[None, :]
    return pos.reshape(-1, rope_dim)


def _axis_frequencies(position: np.ndarray, dim: int, theta: float) -> np.ndarray:
    if dim % 2:
        raise ValueError(f"a RoPE axis needs an even width, got {dim}")
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    omega = 1.0 / (theta**scale)
    angles = np.outer(position.astype(np.float64), omega)  # (seq, dim // 2)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def get_rope_frequencies(
    position_indices: np.ndarray,  # (seq, n_axes)
    dim_sizes: Sequence[int],
    theta: float,
) -> np.ndarray:
    """(seq, sum(dim_sizes) // 2, 2) cos/sin table."""
    if len(dim_sizes) != position_indices.shape[-1]:
        raise ValueError(f"{len(dim_sizes)} axis widths for {position_indices.shape[-1]} axes")
    return np.concatenate(
        [
            _axis_frequencies(position_indices[..., i], dim, theta)
            for i, dim in enumerate(dim_sizes)
        ],
        axis=-2,
    )


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, D) by freqs (S, D/2, 2) broadcast against it, in
    fp32 on (even, odd) pairs; the result in x's dtype."""
    xf = x.float()
    cos, sin = freqs[..., 0], freqs[..., 1]
    even, odd = xf[..., 0::2], xf[..., 1::2]
    rotated = torch.stack([even * cos - odd * sin, even * sin + odd * cos], dim=-1)
    return rotated.reshape(xf.shape).to(x.dtype)


def apply_rope_qk(
    q: torch.Tensor, k: torch.Tensor, rope_freqs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    return apply_rope(q, rope_freqs), apply_rope(k, rope_freqs)


class RoPEFrequency:
    """Parameterless frequency provider."""

    def __init__(self, dim_sizes: Sequence[int], theta: float):
        self.dim_sizes = list(dim_sizes)
        self.theta = theta

    def get_image_position_indices(
        self, height: int, width: int, y_index: int = 1, x_index: int = 2
    ) -> np.ndarray:
        return image_position_indices(height, width, len(self.dim_sizes), y_index, x_index)

    def get_text_position_indices(self, seq_len: int) -> np.ndarray:
        return np.zeros((seq_len, len(self.dim_sizes)), np.float32)

    def __call__(self, position_indices: np.ndarray, device=None) -> torch.Tensor:
        table = get_rope_frequencies(position_indices, self.dim_sizes, self.theta)
        return torch.from_numpy(table).to(device)
