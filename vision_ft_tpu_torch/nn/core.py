"""Layer set of the port (``vision_ft_tpu/nn/core.py`` counterpart).

Dense paths only: no LoRA/LoHa deltas, no quantized weight subtrees, no
remat names. Parameter names and shapes are the JAX package's, so a
module's ``state_dict()`` keys equal ``nn.core.flatten_params`` of the
JAX module's params:

  - Linear weight: (out_features, in_features) (+ bias (out,))
  - Conv2d weight: (out_ch, in_ch, kh, kw) (OIHW)
  - norm scales/offsets: ``weight``/``bias``

Layout: ``Conv2d`` and ``GroupNorm`` take and return NHWC activations,
like the JAX package. Inside, the NHWC tensor is handed to PyTorch as an
NCHW view with channels-last strides, so no copy is made around a conv.

Random init goes through :func:`init_parameters_` with an explicit
``torch.Generator`` (the JAX ``init(key, dtype)`` counterpart); the
distributions are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layer_norm import layer_norm, layer_norm_reference


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch nn.Linear default: U(-1/sqrt(in), 1/sqrt(in)), as the JAX init
        bound = 1.0 / math.sqrt(self.in_features)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Module):
    """2-D convolution over NHWC activations with OIHW-stored kernels."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        bias: bool = True,
    ):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.in_channels * self.kernel_size**2)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (B, H, W, C) -> NCHW view with channels-last strides -> NHWC
        y = F.conv2d(
            x.permute(0, 3, 1, 2), self.weight, self.bias,
            stride=self.stride, padding=self.padding,
        )
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics.

    bf16 inputs on the card with an affine and C % 128 == 0 go through
    the fused LayerNorm kernel (``ops/layer_norm.py``), the rule of the
    JAX ``LayerNorm`` with ``is_cuda`` in place of the TPU check; every
    other input takes the plain formula.
    """

    def __init__(
        self, dim: int, eps: float = 1e-5, elementwise_affine: bool = True, bias: bool = True
    ):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim)) if elementwise_affine else None
        self.bias = (
            nn.Parameter(torch.empty(dim)) if bias and elementwise_affine else None
        )

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (
            x.is_cuda
            and x.dtype == torch.bfloat16
            and self.weight is not None
            and self.dim % 128 == 0
            and x.ndim >= 2
        ):
            return layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm_reference(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC activations (statistics in fp32)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(num_channels)) if affine else None
        self.bias = nn.Parameter(torch.empty(num_channels)) if affine else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight is not None:
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(
            x.permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias, self.eps
        )
        return y.permute(0, 2, 3, 1)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


_LEAVES = (Linear, Conv2d, LayerNorm, GroupNorm, Embedding)


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in place, on the device and in the dtype the module's
    parameters already have. Every parameter of the port belongs to one
    of the leaf layers above; a parameter that does not is an error."""
    covered = set()
    for m in module.modules():
        if isinstance(m, _LEAVES):
            m.reset_parameters(generator)
            covered.update(id(p) for p in m.parameters(recurse=False))
    stray = [n for n, p in module.named_parameters() if id(p) not in covered]
    if stray:
        raise TypeError(f"parameters outside the port's leaf layers: {stray[:5]}")
    return module
