"""KL autoencoder (SD/SDXL VAE), ``vision_ft_tpu/models/autoencoder/kl.py``
counterpart, diffusers key layout.

The whole module tree is ported, so that the JAX package's parameters
load with strict keys; of the entry points only ``decode`` is (the
SDXL generate path). All tensors are NHWC; latents (B, H/8, W/8, C).
The mid-block attention is single-head over HW tokens and runs the
plain formula ("xla" backend, as in the JAX package). Not ported yet:
``encode`` / ``DiagonalGaussian`` and ``tiled_decode``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Conv2d, GroupNorm, Linear
from ...ops.attention import scaled_dot_product_attention


@dataclass
class AutoencoderKLConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    # pipeline-level attributes
    compression_ratio: int = 8
    scaling_factor: float = 0.13025
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    mid_block_add_attention: bool = True


SDXL_VAE_CONFIG = AutoencoderKLConfig()


class ResnetBlock(nn.ModuleDict):
    def __init__(self, in_ch: int, out_ch: int, groups: int = 32):
        children = {
            "norm1": GroupNorm(groups, in_ch, eps=1e-6),
            "conv1": Conv2d(in_ch, out_ch, 3, padding=1),
            "norm2": GroupNorm(groups, out_ch, eps=1e-6),
            "conv2": Conv2d(out_ch, out_ch, 3, padding=1),
        }
        if in_ch != out_ch:
            children["conv_shortcut"] = Conv2d(in_ch, out_ch, 1)
        super().__init__(children)

    def forward(self, x):
        h = self["conv1"](F.silu(self["norm1"](x)))
        h = self["conv2"](F.silu(self["norm2"](h)))
        if "conv_shortcut" in self:
            x = self["conv_shortcut"](x)
        return x + h


class VAEAttention(nn.ModuleDict):
    """Single-head full attention over HW tokens (diffusers Attention)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__(
            {
                "group_norm": GroupNorm(groups, channels, eps=1e-6),
                "to_q": Linear(channels, channels),
                "to_k": Linear(channels, channels),
                "to_v": Linear(channels, channels),
                "to_out": nn.ModuleDict({"0": Linear(channels, channels)}),
            }
        )

    def forward(self, x):
        b, h, w, c = x.shape
        t = self["group_norm"](x).reshape(b, h * w, c)
        q = self["to_q"](t)[:, None]  # (b, 1 head, hw, c)
        k = self["to_k"](t)[:, None]
        v = self["to_v"](t)[:, None]
        attn = scaled_dot_product_attention(q, k, v)[:, 0]
        return self["to_out"]["0"](attn).reshape(b, h, w, c) + x


class MidBlock(nn.ModuleDict):
    def __init__(self, channels: int, groups: int = 32, add_attention: bool = True):
        children = {
            "resnets": nn.ModuleDict(
                {
                    "0": ResnetBlock(channels, channels, groups),
                    "1": ResnetBlock(channels, channels, groups),
                }
            ),
        }
        if add_attention:
            children["attentions"] = nn.ModuleDict({"0": VAEAttention(channels, groups)})
        super().__init__(children)

    def forward(self, x):
        x = self["resnets"]["0"](x)
        if "attentions" in self:
            x = self["attentions"]["0"](x)
        return self["resnets"]["1"](x)


class Downsampler(nn.ModuleDict):
    """Stride-2 conv (diffusers pads it (0,1)x(0,1)); parameters only."""

    def __init__(self, channels: int):
        super().__init__({"conv": Conv2d(channels, channels, 3, stride=2, padding=0)})


class Upsampler(nn.ModuleDict):
    def __init__(self, channels: int):
        super().__init__({"conv": Conv2d(channels, channels, 3, padding=1)})

    def forward(self, x):
        x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
        return self["conv"](x.permute(0, 2, 3, 1))


class Encoder(nn.Module):
    """The encoder's parameters, for strict key loading; its forward
    (image encode) is not ported yet."""

    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        chs = config.block_out_channels
        g = config.norm_num_groups
        self.conv_in = Conv2d(config.in_channels, chs[0], 3, padding=1)
        blocks = {}
        in_ch = chs[0]
        for i, out_ch in enumerate(chs):
            block = {
                "resnets": nn.ModuleDict(
                    {
                        str(j): ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g)
                        for j in range(config.layers_per_block)
                    }
                )
            }
            if i != len(chs) - 1:
                block["downsamplers"] = nn.ModuleDict({"0": Downsampler(out_ch)})
            blocks[str(i)] = nn.ModuleDict(block)
            in_ch = out_ch
        self.down_blocks = nn.ModuleDict(blocks)
        self.mid_block = MidBlock(chs[-1], g, config.mid_block_add_attention)
        self.conv_norm_out = GroupNorm(g, chs[-1], eps=1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * config.latent_channels, 3, padding=1)


class Decoder(nn.Module):
    def __init__(self, config: AutoencoderKLConfig):
        super().__init__()
        rev = list(reversed(config.block_out_channels))
        g = config.norm_num_groups
        self.conv_in = Conv2d(config.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g, config.mid_block_add_attention)
        blocks = {}
        in_ch = rev[0]
        for i, out_ch in enumerate(rev):
            block = {
                "resnets": nn.ModuleDict(
                    {
                        str(j): ResnetBlock(in_ch if j == 0 else out_ch, out_ch, g)
                        for j in range(config.layers_per_block + 1)
                    }
                )
            }
            if i != len(rev) - 1:
                block["upsamplers"] = nn.ModuleDict({"0": Upsampler(out_ch)})
            blocks[str(i)] = nn.ModuleDict(block)
            in_ch = out_ch
        self.up_blocks = nn.ModuleDict(blocks)
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = Conv2d(rev[-1], config.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks.values():
            for resnet in block["resnets"].values():
                h = resnet(h)
            if "upsamplers" in block:
                h = block["upsamplers"]["0"](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Full VAE; keys ``encoder.*``, ``decoder.*`` (+ the quant convs)."""

    def __init__(self, config: AutoencoderKLConfig = SDXL_VAE_CONFIG):
        super().__init__()
        self.config = config
        self.compression_ratio = config.compression_ratio
        self.scaling_factor = config.scaling_factor
        self.shift_factor = config.shift_factor
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        c = config.latent_channels
        if config.use_quant_conv:
            self.quant_conv = Conv2d(2 * c, 2 * c, 1)
            self.post_quant_conv = Conv2d(c, c, 1)
        else:
            self.quant_conv = None
            self.post_quant_conv = None

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, h, w, C) -> image (B, 8h, 8w, 3), NHWC."""
        if self.post_quant_conv is not None:
            z = self.post_quant_conv(z)
        return self.decoder(z)
