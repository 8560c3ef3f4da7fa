"""SigLIP vision tower in the timm ViT key layout
(``vision_ft_tpu/models/vision_encoders/siglip.py`` counterpart): the
IP-Adapter's default image encoder (``timm/vit_base_patch16_siglip_384``),
run by the port itself on the model's device.

- 16x16 conv patch embedding, no class token, learned position embeddings;
- pre-LN blocks: LN -> fused-qkv attention -> LN -> GELU (tanh) MLP;
- a final LN, then a MAP head (``AttentionPoolLatent``): one learned latent
  query attends over the sequence, plus an MLP residual; the pooled output
  is that token.

On the card a block's attention over its 576 tokens (384 px) is the BSHD
flash kernel (kernel B) at head dim 64 with 12 heads, and its LayerNorms
(C 768, eps 1e-6) the LayerNorm kernel (kernel A), for bf16 tensors; the
MAP head's one-query attention takes the plain formula.

State-dict keys are timm's (``patch_embed.proj.weight``, ``pos_embed``,
``blocks.N.attn.qkv.weight``, ``attn_pool.latent``, ...), as the JAX
package's flattened params.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d, LayerNorm, Linear, init_parameters_, load_flat_params
from ...ops.attention import attention_heads_packed
from ...utils.dtype import str_to_dtype


@dataclass
class SigLIPVisionConfig:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    patch_size: int = 16
    image_size: int = 384

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class _Attention(nn.ModuleDict):
    def __init__(self, dim: int, num_heads: int):
        super().__init__({"qkv": Linear(dim, dim * 3), "proj": Linear(dim, dim)})
        self.num_heads = num_heads

    def forward(self, x):
        q, k, v = self["qkv"](x).chunk(3, dim=-1)
        return self["proj"](attention_heads_packed(q, k, v, self.num_heads, backend="flash"))


class _MLP(nn.ModuleDict):
    def __init__(self, dim: int, hidden: int):
        super().__init__({"fc1": Linear(dim, hidden), "fc2": Linear(hidden, dim)})

    def forward(self, x):
        return self["fc2"](F.gelu(self["fc1"](x), approximate="tanh"))


class _Block(nn.ModuleDict):
    def __init__(self, config: SigLIPVisionConfig):
        super().__init__(
            {
                "norm1": LayerNorm(config.hidden_size, eps=1e-6),
                "attn": _Attention(config.hidden_size, config.num_heads),
                "norm2": LayerNorm(config.hidden_size, eps=1e-6),
                "mlp": _MLP(config.hidden_size, config.mlp_dim),
            }
        )

    def forward(self, x):
        x = x + self["attn"](self["norm1"](x))
        return x + self["mlp"](self["norm2"](x))


class _AttentionPoolLatent(nn.ModuleDict):
    """timm's MAP head: a learned latent query over the sequence + MLP."""

    def __init__(self, config: SigLIPVisionConfig):
        dim = config.hidden_size
        super().__init__(
            {
                "q": Linear(dim, dim),
                "kv": Linear(dim, dim * 2),
                "proj": Linear(dim, dim),
                "norm": LayerNorm(dim, eps=1e-6),
                "mlp": _MLP(dim, config.mlp_dim),
            }
        )
        self.num_heads = config.num_heads
        self.dim = dim
        self.latent = nn.Parameter(torch.empty(1, 1, dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.latent.normal_(0.0, 1.0, generator=generator).mul_(self.dim**-0.5)

    def forward(self, x):
        b = x.shape[0]
        q = self["q"](self.latent.to(x.dtype).expand(b, 1, self.dim))
        k, v = self["kv"](x).chunk(2, dim=-1)
        out = self["proj"](attention_heads_packed(q, k, v, self.num_heads, backend="xla"))
        out = out + self["mlp"](self["norm"](out))
        return out[:, 0]


class _PatchEmbed(nn.Module):
    def __init__(self, config: SigLIPVisionConfig):
        super().__init__()
        self.proj = Conv2d(3, config.hidden_size, config.patch_size, stride=config.patch_size)


class SigLIPVisionModel(nn.Module):
    """(B, H, W, 3) normalized pixels -> (last hidden state, penultimate
    hidden state, pooled); the IP-Adapter's default reads
    ``hidden_state_index=-2``, the penultimate."""

    def __init__(self, config: SigLIPVisionConfig = SigLIPVisionConfig()):
        super().__init__()
        self.config = config
        self.patch_embed = _PatchEmbed(config)
        self.pos_embed = nn.Parameter(torch.empty(1, config.num_patches, config.hidden_size))
        self.blocks = nn.ModuleDict({str(i): _Block(config) for i in range(config.num_layers)})
        self.norm = LayerNorm(config.hidden_size, eps=1e-6)
        self.attn_pool = _AttentionPoolLatent(config)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values: torch.Tensor):
        x = self.patch_embed.proj(pixel_values)
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c) + self.pos_embed.to(x.dtype)
        penultimate = x
        blocks = list(self.blocks.values())
        for i, block in enumerate(blocks):
            if i == len(blocks) - 1:
                penultimate = x
            x = block(x)
        x = self.norm(x)
        return x, penultimate, self.attn_pool(x)


class ImageEncoder:
    """The IP-Adapter's ``image_encoder`` callable (the JAX package's
    ``JaxImageEncoder``): a (B, H, W, C) batch in [-1, 1] (a tensor, or
    numpy, moved to the model's device) -> the features, a tensor on the
    model's device in the model's dtype, computed under ``no_grad`` with
    no host round trip. Seeded random weights unless loaded
    (:meth:`load_state_dict`, timm keys)."""

    def __init__(
        self,
        config: SigLIPVisionConfig = SigLIPVisionConfig(),
        feature_type: str = "hidden_state",
        hidden_state_index: int = -2,
        dtype: torch.dtype | str = torch.bfloat16,
        mean: Sequence[float] = (0.5, 0.5, 0.5),
        std: Sequence[float] = (0.5, 0.5, 0.5),
        device: Optional[torch.device | str] = None,
        seed: int = 0,
    ):
        self.dtype = str_to_dtype(dtype) if isinstance(dtype, str) else dtype
        self.device = torch.device("cuda" if device is None else device)
        with torch.device("meta"):
            self.model = SigLIPVisionModel(config)
        self.model.to(dtype=self.dtype).to_empty(device=self.device)
        init_parameters_(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.model.eval().requires_grad_(False)
        self.feature_type = feature_type
        self.hidden_state_index = hidden_state_index
        # the adapter's preprocessing delivers [-1, 1], which is SigLIP's
        # own 0.5 / 0.5 normalization already
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def load_state_dict(self, state_dict) -> "ImageEncoder":
        load_flat_params(self.model, dict(state_dict))
        self.model.to(dtype=self.dtype)
        self.model.requires_grad_(False)
        return self

    def __call__(self, images) -> torch.Tensor:
        pixels = torch.as_tensor(images).to(self.device, self.dtype)
        with torch.no_grad():
            last, penultimate, pooled = self.model(pixels)
        if self.feature_type == "pooler_output":
            return pooled
        if self.hidden_state_index in (-2, len(self.model.blocks) - 1):
            return penultimate
        return last
