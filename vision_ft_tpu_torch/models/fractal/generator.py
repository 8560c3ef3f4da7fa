"""Fractal masked-autoregressive generator (``vision_ft_tpu/models/fractal/generator.py``
counterpart): the FractalGen-style masked ViT of one recursion level,
whose per-patch outputs condition the next level.

The JAX package's departures from the upstream code are kept: ``forward``
returns the dense per-position tensors and the mask (the upstream gathers
the masked rows), takes ``condition`` already at the hidden width and skips
the upstream's broken concat of the raw guiding pixel (``cond_embedder``
stays in the state dict, unused), and each mask row masks its own count.
So is its fault in the guiding-pixel branch: the pixel transformer gets
``condition``, whose width its ``condition_proj`` takes only where
``hidden_dim`` equals ``in_channels``.

On the card (bf16): the LayerNorms (C a multiple of 128) are kernel A's,
and with ``attention_backend="flash"`` the blocks' attention over 256 keys
or more is kernel E's (``ops.flash_attention.flash_attention``, no mask),
on a sequence of the patches plus the condition tokens (plus one for the
guiding pixel), so its last 64-key tile is ragged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...modules.patch import patchify, unpatchify_cmajor
from ...nn import LayerNorm, Linear
from ...ops.attention import scaled_dot_product_attention
from .pixel import PixelTransformer, _heads


class FractalTransformerBlock(nn.ModuleDict):
    """Pre-LN ViT block."""

    def __init__(self, hidden_dim: int, num_heads: int, qkv_bias: bool = False,
                 mlp_ratio: float = 4.0, backend: str = "xla"):
        inner = int(hidden_dim * mlp_ratio)
        super().__init__({
            "norm1": LayerNorm(hidden_dim),
            "attn": nn.ModuleDict({
                "to_q": Linear(hidden_dim, hidden_dim, bias=qkv_bias),
                "to_k": Linear(hidden_dim, hidden_dim, bias=qkv_bias),
                "to_v": Linear(hidden_dim, hidden_dim, bias=qkv_bias),
                "to_o": Linear(hidden_dim, hidden_dim),
            }),
            "norm2": LayerNorm(hidden_dim),
            "mlp": nn.ModuleDict({"fc1": Linear(hidden_dim, inner), "fc2": Linear(inner, hidden_dim)}),
        })
        self.num_heads = num_heads
        self.backend = backend

    def _attention(self, x: torch.Tensor) -> torch.Tensor:
        a, h = self["attn"], self.num_heads
        out = scaled_dot_product_attention(
            _heads(a["to_q"](x), h), _heads(a["to_k"](x), h), _heads(a["to_v"](x), h),
            backend=self.backend)
        return a["to_o"](out.transpose(1, 2).flatten(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attention(self["norm1"](x))
        h = F.gelu(self["mlp"]["fc1"](self["norm2"](x)), approximate="none")
        return x + self["mlp"]["fc2"](h)


class FractalMaskedTransformerOutput(NamedTuple):
    mask_prediction: torch.Tensor  # (B, S, hidden)
    surrounding_patches: torch.Tensor  # (5, B, S, hidden), dense (select by mask)
    guiding_pixel_loss: torch.Tensor


def _shifted(latent: torch.Tensor) -> torch.Tensor:
    """[center, top, bottom, left, right] zero-padded shifts over the
    (B, h, w, C) grid."""
    top = F.pad(latent[:, :-1], (0, 0, 0, 0, 1, 0))
    bottom = F.pad(latent[:, 1:], (0, 0, 0, 0, 0, 1))
    left = F.pad(latent[:, :, :-1], (0, 0, 1, 0))
    right = F.pad(latent[:, :, 1:], (0, 0, 0, 1))
    return torch.stack([latent, top, bottom, left, right], dim=0)


class FractalMaskedTransformer(nn.Module):
    def __init__(
        self,
        patch_size: int,
        condition_embedding_dim: int,
        hidden_dim: int,
        num_blocks: int,
        num_heads: int,
        in_channels: int = 3,
        out_channels: int = 3,
        qkv_bias: bool = False,
        attention_backend: str = "xla",
        mlp_ratio: float = 4.0,
        use_guiding_pixel: bool = False,
    ):
        super().__init__()
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.use_guiding_pixel = use_guiding_pixel
        self.mask_token = nn.Parameter(torch.empty(1, 1, hidden_dim))
        self.patch_embedder = Linear(in_channels * patch_size**2, hidden_dim)
        self.patch_embed_layer_norm = LayerNorm(hidden_dim, eps=1e-6)
        self.cond_embedder = Linear(condition_embedding_dim, hidden_dim)
        if use_guiding_pixel:
            self.guiding_pixel_embedder = Linear(in_channels, hidden_dim)
            self.pixel_predictor = PixelTransformer(
                channels=in_channels, hidden_dim=hidden_dim, num_blocks=num_blocks,
                num_heads=num_heads, attention_backend=attention_backend,
            )
        self.blocks = nn.ModuleList(
            FractalTransformerBlock(hidden_dim, num_heads, qkv_bias, mlp_ratio, attention_backend)
            for _ in range(num_blocks)
        )
        self.norm = LayerNorm(hidden_dim, eps=1e-6)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.mask_token.normal_(0.0, 0.02, generator=generator)

    # -- patching (c-major feature order) --------------------------------------

    def patchify(self, image: torch.Tensor):
        """NHWC image -> ((B, h*w, C*p*p), h, w)."""
        p = self.patch_size
        return patchify(image, p), image.shape[1] // p, image.shape[2] // p

    def unpatchify(self, patches: torch.Tensor, latent_height: int, latent_width: int):
        return unpatchify_cmajor(patches, latent_height, latent_width, self.patch_size,
                                 self.out_channels)

    def get_surrounding_patches(self, patches: torch.Tensor, latent_height: int,
                                latent_width: int) -> torch.Tensor:
        b, s, c = patches.shape
        latent = patches.reshape(b, latent_height, latent_width, c)
        return _shifted(latent).reshape(5, b, s, c)

    # -- forward ---------------------------------------------------------------

    def predict_mask(
        self,
        patches: torch.Tensor,
        mask: torch.Tensor,  # (B, S) bool, True = masked
        condition: torch.Tensor,  # (B, S_cond, hidden)
        guiding_pixel: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        patches = self.patch_embedder(patches)
        context = torch.cat([condition, patches], dim=1)
        cond_len = condition.shape[1]
        if self.use_guiding_pixel:
            if guiding_pixel is None:
                raise ValueError("a generator with the guiding pixel needs guiding_pixel")
            gp = self.guiding_pixel_embedder(guiding_pixel)[:, None]
            context = torch.cat([gp, context], dim=1)
            cond_len += 1
        b = context.shape[0]
        context_mask = torch.cat(
            [torch.zeros(b, cond_len, dtype=torch.bool, device=mask.device), mask.bool()], dim=1)
        context = torch.where(context_mask[..., None], self.mask_token.to(context.dtype), context)
        context = self.patch_embed_layer_norm(context)
        for block in self.blocks:
            context = block(context)
        return self.norm(context)[:, cond_len:]

    def forward(
        self,
        image: torch.Tensor,  # (B, H, W, C) NHWC
        condition: torch.Tensor,  # (B, S_cond, hidden), already embedded
        mask: torch.Tensor,  # (B, S) bool
        generator: Optional[torch.Generator] = None,
        pixel_labels: Optional[torch.Tensor] = None,
    ) -> FractalMaskedTransformerOutput:
        """With the guiding pixel, its labels are ``pixel_labels`` or drawn
        (the dither) from ``generator``; its loss is the mean negative
        log-likelihood of the three channels' labels, in fp32. The pixel
        transformer reads token 0 of ``condition``, as the JAX package
        passes it: there its width must be ``in_channels`` as well as
        ``hidden_dim``, so the branch runs only where the two are equal
        (else a shape error, there and here)."""
        patches, lh, lw = self.patchify(image)
        if self.use_guiding_pixel:
            if generator is None and pixel_labels is None:
                raise ValueError("the guiding pixel's dither needs a generator (or its labels)")
            guiding_pixel = image.mean(dim=(1, 2))  # (B, C)
            logits, labels = self.pixel_predictor(condition, guiding_pixel, generator,
                                                  pixel_labels)
            logp = torch.log_softmax(logits.reshape(logits.shape[0], 3, 256).float(), dim=-1)
            guiding_pixel_loss = -logp.gather(-1, labels.long()[..., None]).mean()
        else:
            guiding_pixel = None
            guiding_pixel_loss = torch.zeros((), dtype=torch.float32, device=image.device)
        mask_prediction = self.predict_mask(patches, mask, condition, guiding_pixel)
        return FractalMaskedTransformerOutput(
            mask_prediction=mask_prediction,
            surrounding_patches=self.get_surrounding_patches(mask_prediction, lh, lw),
            guiding_pixel_loss=guiding_pixel_loss,
        )
