"""Patchify / unpatchify for NHWC latents (``vision_ft_tpu/modules/patch.py``
counterpart). The feature orders are the JAX package's, so checkpoints
interoperate:

  patchify:   feature dim ordered (c, ph, pw)
  unpatchify: feature dim read as (ph, pw, c)

``unpatchify_cmajor`` reads the (c, ph, pw) order back (Flux's final
layer). ``ImagePatcher`` (CogView4) has no caller in the port yet and is
not ported.
"""

from __future__ import annotations

import torch


def patchify(latent: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h*w, C*p*p) with (c, ph, pw) feature order."""
    b, height, width, c = latent.shape
    p = patch_size
    h, w = height // p, width // p
    x = latent.reshape(b, h, p, w, p, c).permute(0, 1, 3, 5, 2, 4)  # (B, h, w, C, p, p)
    return x.reshape(b, h * w, c * p * p)


def unpatchify(
    patches: torch.Tensor, height: int, width: int, patch_size: int, out_channels: int
) -> torch.Tensor:
    """(B, h*w, p*p*c) -> (B, h*p, w*p, C) with (ph, pw, c) feature order.
    ``height`` / ``width`` are in patches."""
    b = patches.shape[0]
    p = patch_size
    x = patches.reshape(b, height, width, p, p, out_channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, height * p, width * p, out_channels)


def unpatchify_cmajor(
    patches: torch.Tensor, height: int, width: int, patch_size: int, out_channels: int
) -> torch.Tensor:
    """(B, h*w, c*p*p) with (c, ph, pw) feature order -> (B, h*p, w*p, C).
    ``height`` / ``width`` are in patches."""
    b = patches.shape[0]
    p = patch_size
    x = patches.reshape(b, height, width, out_channels, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, height * p, width * p, out_channels)
